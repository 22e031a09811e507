"""In-kernel texture sampling from a packed atlas.

Device-side replacement for the reference's bindless samplers: OpenGL lets the
kernel fetch through a ``sampler2D(uvec2 handle)`` resident handle
(raytrace_utils.glsl:165-166, gpu_texture.h:60-63); XLA has no such thing,
so all textures are packed into one ``[H, W, 3]`` atlas array on the device at load
time (utils/atlas.py) and fetches are bilinear gathers against per-texture
rects — differentiable w.r.t. the atlas texels.
"""

from __future__ import annotations

import jax.numpy as jnp


def _sample_rect(atlas, r, uv, bilinear: bool, quad=None, atlas_w: int = 0):
    """Bilinear (or nearest) fetch inside per-ray rects r [N, 4].

    ``quad`` [H*W, 12] (utils/atlas.build_quad_table) turns the four
    bilinear taps into ONE packed row gather instead of four arbitrary
    2D gathers.  The quad table is a host-built
    COPY of the atlas, so texture-recovery callers that differentiate
    w.r.t. atlas texels must keep ``quad=None`` (the per-tap path's
    gather VJP scatters into the live atlas array)."""
    rx, ry = r[:, 0].astype(jnp.float32), r[:, 1].astype(jnp.float32)
    rw, rh = r[:, 2].astype(jnp.float32), r[:, 3].astype(jnp.float32)

    u = uv[:, 0] % 1.0
    v = uv[:, 1] % 1.0

    # Texel-space coordinates inside the rect (half-texel centered).
    x = u * rw - 0.5
    y = v * rh - 0.5

    if not bilinear:
        xi = rx + jnp.clip(jnp.round(x), 0, rw - 1)
        yi = ry + jnp.clip(jnp.round(y), 0, rh - 1)
        return atlas[yi.astype(jnp.int32), xi.astype(jnp.int32)]

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]

    if quad is not None:
        # The quad row at the (wrapped) base tap holds all four taps
        # with per-rect REPEAT wrap pre-applied.
        xi = (rx + x0 % rw).astype(jnp.int32)
        yi = (ry + y0 % rh).astype(jnp.int32)
        q = quad[yi * atlas_w + xi]
        c00, c10 = q[:, 0:3], q[:, 3:6]
        c01, c11 = q[:, 6:9], q[:, 9:12]
    else:
        def fetch(xo, yo):
            # Repeat-wrap inside the rect, then offset into the atlas.
            xi = (rx + (x0 + xo) % rw).astype(jnp.int32)
            yi = (ry + (y0 + yo) % rh).astype(jnp.int32)
            return atlas[yi, xi]

        c00 = fetch(0.0, 0.0)
        c10 = fetch(1.0, 0.0)
        c01 = fetch(0.0, 1.0)
        c11 = fetch(1.0, 1.0)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def sample_atlas(atlas, rects, tex_index, uv, bilinear: bool = True,
                 mip_rects=None, lod=None, quad=None):
    """Sample RGB from the atlas.

    atlas: [H, W, 3] float32; rects: [K, 4] int32 (x, y, w, h) texel rects;
    tex_index: [N] int32 (clamped; callers mask out untextured hits);
    uv: [N, 2] in [0, 1] with OBJ convention (v up; the loader pre-flips if
    the source image was top-down).  Wrap mode: repeat (GL default used by
    the reference's mipmapped GL_TEXTURE_2D, gpu_texture.h:39-53).

    ``mip_rects`` [K, L, 4] + ``lod`` [N] enable trilinear minification
    (GL_LINEAR_MIPMAP_LINEAR): bilinear taps at floor(lod) and floor(lod)+1
    blended by the fraction.  lod is clamped to the chain; the atlas layer
    stays fully differentiable w.r.t. texels either way.
    """
    idx = jnp.clip(tex_index, 0, rects.shape[0] - 1)
    aw = atlas.shape[1]
    if mip_rects is None or lod is None:
        return _sample_rect(atlas, rects[idx], uv, bilinear, quad=quad,
                            atlas_w=aw)

    levels = mip_rects.shape[1]
    lod = jnp.clip(jnp.asarray(lod, jnp.float32), 0.0, levels - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, levels - 1)
    frac = (lod - l0.astype(jnp.float32))[:, None]
    c0 = _sample_rect(atlas, mip_rects[idx, l0], uv, bilinear, quad=quad,
                      atlas_w=aw)
    c1 = _sample_rect(atlas, mip_rects[idx, l1], uv, bilinear, quad=quad,
                      atlas_w=aw)
    return c0 * (1 - frac) + c1 * frac
