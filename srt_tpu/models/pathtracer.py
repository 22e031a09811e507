"""The wavefront path tracer — the heart of the framework.

Wavefront re-design of the reference GLSL megakernel's path-trace loop
(``GetRayColor``, shaders/raytrace_compute.glsl:208-294).  Instead of one
thread per pixel running a divergent ``while(true)``, the whole image is a
``[N = H*W]`` ray wavefront and each bounce is one batched pass:

  closest hit -> RIS light sample -> shadow ray -> direct lighting
  -> BRDF lobe selection -> Russian roulette -> indirect bounce

with an ``alive`` mask instead of ``break`` (XLA needs static shapes, see
SURVEY.md hard-part #3).  The loop runs ``max_depth`` free bounces plus
``rr_bounces`` Russian-roulette bounces; still-alive paths are then
terminated as a miss.

Data layout is component-first (ops/vec.py): positions/directions/colors are
``[3, N]`` with the ray axis minor so every op reads whole coalesced rows.

Scene geometry is abstracted behind a ``closest_hit(origins, dirs, t_min,
t_max) -> Hit`` callable so spheres (this file) and BVH meshes
(srt_tpu.models.mesh) share one integrator.  Everything is pure jnp and
differentiable w.r.t. scene parameters; discrete choices (hit index, lobe,
RR, light pick) are treated as fixed decisions, so gradients flow through
hit distances, normals, and shading — the standard path-space gradient.
"""

from __future__ import annotations

from typing import Callable

import chex
import jax
import jax.numpy as jnp

from srt_tpu.camera import derive_viewport, generate_rays
from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.ops import brdf
from srt_tpu.ops import intersect
from srt_tpu.ops import vec
from srt_tpu.ops.gather import take_small_t
from srt_tpu.ops.rng import ArrayStream, KeyStream
from srt_tpu.ops.vec import bc
from srt_tpu.scene import Lights, Materials, Spheres
from srt_tpu.models import emitters as emitters_mod

# MIS sentinel: "this direction was not density-sampled" (primary rays,
# delta-specular bounces).  Large against any real area pdf (<= ~1e12 at
# scene scales) yet far from f32 overflow in prev_pdf + pdf_nee.
_NO_MIS_PDF = 1e30


@chex.dataclass(frozen=True)
class Hit:
    """Per-ray hit record (reference ``HitRecord``, raytrace_types.glsl).
    Vectors are [3, N]; scalars [N]; mat fields are per-ray ([3, N]/[N])."""

    hit: jnp.ndarray      # [N] bool
    t: jnp.ndarray        # [N]
    p: jnp.ndarray        # [3, N]
    normal: jnp.ndarray   # [3, N] unit, facing the ray
    mat: Materials        # per-ray gathered material (albedo [3, N], ...)
    # Optional emitted radiance [3, N] (mesh Ke materials); None when the
    # scene has no emission concept (spheres, stubs) — the integrator
    # credits throughput * emitted on hit when present.
    emitted: jnp.ndarray = None
    # Optional global triangle index of the winner ([N] int32, -1 miss;
    # mesh path only) — the hit-side NEE/MIS weight keys its area-pdf
    # lookup on this (r5, cfg.nee).
    tri: jnp.ndarray = None


HitFn = Callable[[jnp.ndarray, jnp.ndarray, float, jnp.ndarray], Hit]


def _materials_t(mats: Materials, idx) -> Materials:
    """Table materials -> per-ray component-first materials."""
    return Materials(
        albedo=take_small_t(mats.albedo, idx),
        specular=take_small_t(mats.specular, idx),
        roughness=take_small_t(mats.roughness[:, None], idx)[0],
        metalness=take_small_t(mats.metalness[:, None], idx)[0],
        use_spec=take_small_t(mats.use_spec[:, None], idx)[0],
    )


def spheres_hit_fn(spheres: Spheres) -> HitFn:
    """Closest-hit closure over a sphere scene (``CheckHit`` sphere loop,
    raytrace_compute.glsl:122-141)."""

    def closest_hit(origins, dirs, t_min, t_max, any_hit=False):
        hit, t, idx = intersect.sphere_hit(
            origins, dirs, spheres.center, spheres.radius, t_min, t_max
        )
        t_safe = jnp.where(hit, t, 1.0)
        p = origins + bc(t_safe) * dirs
        if any_hit:
            # Shadow-ray fast path: occlusion only, skip shading data.
            zeros = jnp.zeros_like(p)
            return Hit(hit=hit, t=t, p=p, normal=zeros,
                       mat=_materials_t(spheres.materials, jnp.zeros_like(idx)))
        center = take_small_t(spheres.center, idx)
        radius = take_small_t(spheres.radius[:, None], idx)[0]
        normal, _front = intersect.sphere_normal(p, center, radius, dirs)
        return Hit(hit=hit, t=t, p=p, normal=normal,
                   mat=_materials_t(spheres.materials, idx))

    return closest_hit


def _supports_kw(fn, name: str) -> bool:
    """True when ``fn`` accepts the optional keyword ``name``.  Resolved
    once from the signature (not by probing the call and swallowing
    TypeError, which would mask genuine TypeErrors inside the hit fn and
    silently disable the optional path)."""
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    if name in sig.parameters:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())


def _supports_any_hit(fn) -> bool:
    return _supports_kw(fn, "any_hit")


def union_hit_fn(*hit_fns: HitFn) -> HitFn:
    """Combine closest-hit functions into one scene: the nearest hit wins.

    The reference switches between spheres and models with the
    ``showModel`` uniform (raytrace_compute.glsl:132-143, either/or);
    this generalizes to heterogeneous scenes (spheres + meshes together).
    Hit fns without an ``any_hit``/``cone`` parameter (detected from the
    signature) are called without it and simply don't get the shadow fast
    path / footprint-driven mips.
    """
    takes_any_hit = tuple(_supports_any_hit(fn) for fn in hit_fns)
    takes_cone = tuple(_supports_kw(fn, "cone") for fn in hit_fns)

    def closest_hit(origins, dirs, t_min, t_max, any_hit=False, cone=None):
        best = None
        for fn, supported, with_cone in zip(hit_fns, takes_any_hit,
                                            takes_cone):
            kw = {}
            if supported:
                kw["any_hit"] = any_hit
            if with_cone and cone is not None:
                kw["cone"] = cone
            rec = fn(origins, dirs, t_min, t_max, **kw)
            if best is None:
                best = rec
                continue
            closer = rec.hit & (~best.hit | (rec.t < best.t))

            def sel(a, b, m=closer):
                # Vectors are [3, N] (mask broadcasts on axis 0); scalars [N].
                return jnp.where(m[None, :] if a.ndim > m.ndim else m, a, b)

            # Emission: treat a missing field as zeros when the other
            # branch carries one (heterogeneous sphere + mesh scenes).
            if rec.emitted is None and best.emitted is None:
                emitted = None
            else:
                e_new = rec.emitted if rec.emitted is not None \
                    else jnp.zeros_like(best.emitted)
                e_old = best.emitted if best.emitted is not None \
                    else jnp.zeros_like(rec.emitted)
                emitted = sel(e_new, e_old)
            # Triangle ids: a branch without the concept contributes -1
            # (its hits carry no NEE area pdf — sphere emitters do not
            # exist, so the MIS weight correctly degenerates to 1).
            if rec.tri is None and best.tri is None:
                tri = None
            else:
                miss = jnp.full(best.hit.shape, -1, jnp.int32)
                tri = sel(rec.tri if rec.tri is not None else miss,
                          best.tri if best.tri is not None else miss)
            best = Hit(
                hit=best.hit | rec.hit,
                t=jnp.where(closer, rec.t, best.t),
                p=sel(rec.p, best.p),
                normal=sel(rec.normal, best.normal),
                mat=jax.tree_util.tree_map(sel, rec.mat, best.mat),
                emitted=emitted,
                tri=tri,
            )
        return best

    return closest_hit


def _part1by2(x):  # spread 5 bits with 2-bit gaps
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def _part1by1(x):  # spread 15 bits with 1-bit gaps
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x


def _morton15(pts):
    """15-bit Morton cell code of [3, N] points within their own bounding
    box (5 bits/axis)."""
    lo = jnp.min(pts, axis=1, keepdims=True)
    hi = jnp.max(pts, axis=1, keepdims=True)
    q = jnp.clip(((pts - lo) / jnp.maximum(hi - lo, 1e-6)) * 31.0,
                 0.0, 31.0).astype(jnp.uint32)          # [3, N] 5-bit cells
    return (_part1by2(q[0]) << 2) | (_part1by2(q[1]) << 1) | _part1by2(q[2])


def _bounce_sort_keys(origins, dirs, alive, bounce=None):
    """Coherence keys for re-sorting the wavefront between bounces.

    Indirect bounce rays scatter over the surface with random directions,
    so kernel tiles lose the Morton coherence of the primary wavefront and
    their active-cluster unions blow up.  Two keys, picked per bounce
    (r5 offline ordering study, tools/micro_sortkeys.py on real dumped
    wavefronts):

    * ``cell-major`` (dead-last, origin Morton cell, ~30-degree direction
      cone) — best for the still-coherent bounce-2 wavefront (mirror-like
      reflections of the primary beam: footprints are tiny and origin
      locality dominates);
    * ``6-D interleave`` (dead-last, then the bitwise interleave of a
      15-bit direction Morton code with the 15-bit origin Morton code) —
      best for bounces >= 3: locality in direction AND origin at every
      scale.  Supersedes the first r5 cone-major key (9-bit direction
      cell, then origin): cone-major was best at bounce 3 (union 47.1 vs
      86.6 cell-major at G=32) but poor at bounce 4 (2.47 evals/ray vs
      cell-major-with-cone 1.99); the interleave measures 2.05/2.08
      evals/ray at bounces 3/4 — robust at both.  Same-pixel spp batches
      were measured WORSE (union 154 at G=32): equal origins buy nothing
      once lobes diverge — see ROADMAP r5.

    ``bounce`` is the (traced) bounce index whose OUTPUT wavefront is
    being sorted; None keeps the cell-major key (legacy callers).  Pure
    value-level work: static shapes, one u32 key per ray.
    """
    morton = _morton15(origins)
    # 2 bits/axis of the unit direction: a ~30-degree cone per bucket —
    # sign-only octants leave 90-degree fans whose supercluster unions
    # cover most of the scene by bounce 3 (measured).
    inv_len = jax.lax.rsqrt(jnp.maximum(
        jnp.sum(dirs * dirs, axis=0), 1e-12))
    dirs_n = dirs * inv_len
    qd = jnp.clip((dirs_n + 1.0) * 2.0, 0.0, 3.0).astype(jnp.uint32)
    dm = (((qd[0] >> 1) << 5) | ((qd[1] >> 1) << 4) | ((qd[2] >> 1) << 3)
          | ((qd[0] & 1) << 2) | ((qd[1] & 1) << 1) | (qd[2] & 1))
    dead = (~alive).astype(jnp.uint32)
    key_cell = (dead << 21) | (morton << 6) | dm
    if bounce is None:
        return key_cell
    # 15-bit direction Morton code (5 bits/axis), bit-interleaved with
    # the 15-bit origin code: the 6-D Morton order.
    qd5 = jnp.clip((dirs_n + 1.0) * 16.0, 0.0, 31.0).astype(jnp.uint32)
    dm15 = ((_part1by2(qd5[0]) << 2) | (_part1by2(qd5[1]) << 1)
            | _part1by2(qd5[2]))
    key_6d = (dead << 30) | (_part1by1(dm15) << 1) | _part1by1(morton)
    return jnp.where(jnp.asarray(bounce) >= 1, key_6d, key_cell)


def _occluded(closest_hit: HitFn, p, light_pos, t_min, active=None):
    """Shadow ray (``CheckLightOccluded``, raytrace_compute.glsl:167-176):
    cast p -> light, occluded if anything hits before the light.
    ``active`` masks dead lanes with t_max = 0 so compaction-aware
    intersectors (the GPU kernel) exit them at once.

    See ``_occluded_sorted`` for the batch-re-sorted variant used on
    late bounces (an r3 rejection overturned in r5 — history in its
    docstring)."""
    delta = light_pos - p
    dist2 = vec.norm2(delta)
    dist = jnp.sqrt(jnp.where(dist2 > 0.0, dist2, 1.0))
    if active is not None:
        dist = jnp.where(active, dist, 0.0)
    direction = vec.normalize(delta)
    shadow = closest_hit(p, direction, t_min, dist, any_hit=True)
    return shadow.hit


def _occluded_sorted(closest_hit: HitFn, p, light_pos, light_idx, t_min,
                     active):
    """``_occluded`` with a (dead-last, picked-light, origin-Morton-cell)
    re-sort of the shadow batch before the any-hit trace.

    RIS samples a light PER RAY (glsl:228-246), so adjacent rays of the
    bounce-sorted wavefront aim at different lights; a per-group walk
    (``pg2:G:W``) then pays the union footprint of segments toward up to
    six lights per group.  Grouping same-light segments from nearby
    origins collapses that union toward a single cone (r5: the bounce-3/4
    shadow passes cost as much as their closest-hit passes without this).
    Occlusion answers are order-independent booleans — the inverse
    permutation restores wavefront order, image bit-identical.

    (The r3 light-only stable sort was rejected at ~57 ms/frame of sort +
    gather glue under the TILED walk, where per-ray dynamic gating left
    little for grouping to win.  Both sides changed in r4/r5: permutes
    are now one packed row gather (~ms), and the per-group walk's cost IS
    the group-union footprint — so the informed retry, with origins in
    the key, is a measured win; see ROADMAP r5.)"""
    delta = light_pos - p
    dist2 = vec.norm2(delta)
    dist = jnp.sqrt(jnp.where(dist2 > 0.0, dist2, 1.0))
    dist = jnp.where(active, dist, 0.0)
    direction = vec.normalize(delta)
    key = (((~active).astype(jnp.uint32) << 19)
           | (jnp.clip(light_idx, 0, 15).astype(jnp.uint32) << 15)
           | _morton15(p))
    order = jnp.argsort(key)
    packed = jnp.concatenate([p, direction, dist[None, :]], axis=0)
    sp = packed.T[order].T                  # one packed row gather
    shadow = closest_hit(sp[0:3], sp[3:6], t_min, sp[6], any_hit=True)
    inv = jnp.argsort(order)                # argsort of a permutation
    occ = shadow.hit.astype(jnp.float32)[:, None][inv][:, 0]
    return occ > 0.0


def _sky(dirs, cfg: RenderConfig):
    """Sky radiance: constant dark grey by default, or the RTiOW blue
    gradient (both appear at raytrace_compute.glsl:219-220).  [3, N]/[3, 1]."""
    if not cfg.sky_gradient:
        return jnp.asarray(cfg.sky_color, jnp.float32)[:, None]
    d = vec.normalize(dirs)
    a = 0.5 * (d[1] + 1.0)
    white = vec.col([1.0, 1.0, 1.0])
    blue = vec.col([0.5, 0.7, 1.0])
    return bc(1.0 - a) * white + bc(a) * blue


def bounce_step(closest_hit: HitFn, lights: Lights, cfg: RenderConfig,
                carry, bounce, u, sort: bool, shadow_fn=None,
                return_aux: bool = False, emitters=None):
    """One path-tracing bounce on a wavefront slice — the body shared by
    the ``lax.scan`` integrator below and the width-scheduled compact
    driver (models/wavefront_compact.py), so the two cannot drift.

    ``carry`` = (origins, dirs, throughput, color, alive, pix) — plus
    (cone_width, cone_spread) when ``cfg.ray_cones`` — all in wavefront
    order at the slice's width; ``u`` [D, W] is this bounce's per-ray
    uniform block ALREADY gathered to wavefront order.  ``sort`` applies
    the live-first coherence re-sort at the end (see
    ``_bounce_sort_keys``).  Returns (carry', stats) with stats =
    (rays traced, shadow rays) for honest Mrays/s accounting.

    ``shadow_fn(closest_hit, p, l_pos, t_min, active) -> mult [N]``
    replaces the binary occlusion test with a continuous light-visibility
    multiplier — the hook the edge-aware renderers use to make SHADOW
    boundaries differentiable (models/edge_aware.soft_shadow_fn); None
    keeps ``CheckLightOccluded`` semantics.

    ``return_aux=True`` (requires ``sort=False``: the aux stays in the
    slice's input order) additionally returns a dict with this bounce's
    hit record essentials and lobe decision — what the edge-aware
    REFLECTION modules need to reparameterize the next segment's
    visibility without re-deriving integrator internals:
    ``{"take_spec", "rough", "hit", "t"}``.

    ``emitters`` + ``cfg.nee`` (r5): next-event estimation toward
    emissive triangles (models/emitters.py), combined with BSDF sampling
    by the one-sample balance heuristic.  The carry gains a trailing
    ``prev_pdf`` [N] channel (the mixture pdf of the direction that led
    here; ``_NO_MIS_PDF`` for primaries and delta-specular bounces) and
    each bounce consumes 3 extra tail slots (ops/rng.bounce_slots)."""
    nee_on = emitters is not None and cfg.nee
    fields = list(carry)
    origins, dirs, throughput, color, alive, pix = fields[:6]
    k = 6
    cone = None
    if cfg.ray_cones:
        cwidth, cspread = fields[k], fields[k + 1]
        cone = (cwidth, cspread)
        k += 2
    prev_pdf = fields[k] if nee_on else None
    num_lights = lights.count
    takes_cone = cone is not None and _supports_kw(closest_hit, "cone")
    # Dead lanes trace with t_max = 0: the BVH walks then exit at the
    # root box.
    rec = closest_hit(
        origins, dirs, cfg.t_min, jnp.where(alive, jnp.inf, 0.0),
        **({"cone": cone} if takes_cone else {})
    )
    active = alive & rec.hit

    # Emissive surfaces contribute directly (mesh Ke materials; the
    # reference parses Ke but never shades it, model_loader.cpp:240).
    # With NEE the hit-side credit carries the balance-heuristic MIS
    # weight prev_pdf / (prev_pdf + pdf_nee(hit)): primaries and
    # delta-specular bounces arrive with prev_pdf = _NO_MIS_PDF -> w ~ 1,
    # and non-emitter hits have tri_pdfa = 0 -> w = 1 exactly.
    if rec.emitted is not None:
        credit = throughput * rec.emitted
        if nee_on and rec.tri is not None:
            pdfa_hit = emitters.tri_pdfa[jnp.maximum(rec.tri, 0)]
            cos_hit = jnp.abs(jnp.sum(rec.normal * dirs, axis=0))
            # t guarded to keep inf*0 NaNs out of unselected where
            # branches (they poison reverse-mode gradients).
            t_h = jnp.where(active, rec.t, 1.0)
            pdf_nee_hit = pdfa_hit * t_h * t_h \
                / jnp.maximum(cos_hit, 1e-6)
            credit = credit * bc(prev_pdf / (prev_pdf + pdf_nee_hit))
        color = color + jnp.where(bc(active), credit, 0.0)

    # Paths that miss exit with sky * throughput
    # (raytrace_compute.glsl:287-292).
    missed = alive & ~rec.hit
    color = color + jnp.where(
        bc(missed), throughput * _sky(dirs, cfg), 0.0
    )

    view = vec.normalize(-dirs)

    # --- RIS light sampling + direct lighting (glsl:228-246) ---
    u_idx = u[0:num_lights]
    u_sel = u[num_lights:2 * num_lights]
    sampled, light_idx, light_w = brdf.sample_lights_ris(
        rec.p, lights, u_idx, u_sel
    )
    l_pos = take_small_t(lights.position, light_idx)
    l_col = take_small_t(lights.color, light_idx)
    l_int = take_small_t(lights.intensity[:, None], light_idx)[0]

    if shadow_fn is None:
        # Skip shadow rays that cannot matter: a failed RIS draw zeroes
        # light_w, and a light behind the shading normal zeroes both
        # direct evaluators (saturate(NdotL) gates the diffuse term and
        # the masking term G(ndl=0) = 0 kills the GGX term) — the
        # occlusion answer multiplies an exact 0 either way.  Masked
        # lanes get t_max = 0, so the direction-sorted wavefront hands
        # the traversal kernels whole dead groups to skip (r5; the
        # reference traces these rays, raytrace_compute.glsl:167-176).
        ndl_pos = jnp.sum(
            rec.normal * brdf.light_dir_to(rec.p, l_pos), axis=0) > 0.0
        shadow_active = active & sampled & ndl_pos
        if (cfg.sort_shadows_from is not None and isinstance(bounce, int)
                and bounce >= cfg.sort_shadows_from):
            occ = _occluded_sorted(closest_hit, rec.p, l_pos, light_idx,
                                   cfg.t_min, shadow_active)
        else:
            occ = _occluded(closest_hit, rec.p, l_pos, cfg.t_min,
                            active=shadow_active)
        shadow_mult = jnp.where(occ, 0.0, 1.0)
    else:
        shadow_active = active
        shadow_mult = shadow_fn(closest_hit, rec.p, l_pos, cfg.t_min,
                                active)

    direct_spec = brdf.sample_direct(
        rec.p, rec.normal, view, rec.mat, l_pos, l_col, l_int, shadow_mult
    ) * bc(light_w)

    if cfg.uniform_use_spec:
        # Every material is specular (mesh conversion guarantees it,
        # raytrace_utils.glsl:173): the diffuse variant below would be
        # computed then discarded by the where — skip it outright.
        direct = direct_spec
    else:
        l_dir = brdf.light_dir_to(rec.p, l_pos)
        falloff = brdf.light_falloff(rec.p, l_pos)
        light_term = l_col * bc(falloff * l_int * light_w)
        direct_diff = (
            brdf.sample_direct_new(rec.normal, l_dir, view, rec.mat)
            * bc(shadow_mult) * light_term
        )
        direct = jnp.where(bc(rec.mat.use_spec), direct_spec, direct_diff)
    add = active & sampled
    color = color + jnp.where(bc(add), throughput * direct, 0.0)

    # --- NEE toward emissive triangles (r5, cfg.nee; no reference
    # analog — Ke is parsed but never lit, model_loader.cpp:240-273) ---
    if nee_on:
        u_nee = u[2 * num_lights + 6:2 * num_lights + 9]
        x_l, n_l, le_s, pdf_a = emitters_mod.sample_emitters(
            emitters, u_nee[0], u_nee[1], u_nee[2])
        delta_l = x_l - rec.p
        d2 = jnp.maximum(vec.norm2(delta_l), 1e-12)
        dist = jnp.sqrt(d2)
        wi = delta_l / bc(dist)
        cos_l = jnp.abs(jnp.sum(n_l * wi, axis=0))       # two-sided Ke
        front = jnp.sum(rec.normal * wi, axis=0) > 0.0
        pdf_nee = pdf_a * d2 / jnp.maximum(cos_l, 1e-6)
        # Same per-bounce GGX half-vector draw as sample_indirect below:
        # the diffuse lobe's implied Fresnel then matches the BSDF-side
        # estimator exactly (see brdf.eval_lobes_pdf).
        u4 = u[2 * num_lights + 2:2 * num_lights + 6]
        h_rand = brdf.sample_ggx_half_vector(
            rec.normal, rec.mat.roughness, u4[2], u4[3])
        fcos, pdf_mix_l = brdf.eval_lobes_pdf(
            rec.normal, view, wi, rec.mat, h_diffuse=h_rand)
        nee_active = active & front & (cos_l > 1e-6)
        # Shadow segment shrunk off the emitter surface so the sampled
        # triangle itself does not occlude its own sample.
        occ_nee = _occluded(closest_hit, rec.p,
                            rec.p + delta_l * 0.999, cfg.t_min,
                            active=nee_active)
        vis = nee_active & ~occ_nee
        # Balance heuristic folded: w_nee / pdf_nee = 1/(pdf_nee+pdf_mix).
        contrib = le_s * fcos * bc(1.0 / jnp.maximum(
            pdf_nee + pdf_mix_l, 1e-12))
        color = color + jnp.where(bc(vis), throughput * contrib, 0.0)

    # --- BRDF lobe selection (glsl:248-264) ---
    u_lobe = u[2 * num_lights]
    forced_spec = (rec.mat.metalness == 1.0) & (rec.mat.roughness == 0.0)
    prob = brdf.brdf_probability(rec.mat, view, rec.normal)
    chose_spec = u_lobe < prob
    take_spec = forced_spec | chose_spec
    lobe_scale = jnp.where(
        forced_spec,
        1.0,
        jnp.where(chose_spec, 1.0 / prob, 1.0 / (1.0 - prob)),
    )
    throughput = jnp.where(
        bc(active), throughput * bc(lobe_scale), throughput
    )

    # --- Russian roulette (glsl:266-274), active once bounce passes
    # max_depth (dynamic within the scan) ---
    u_rr = u[2 * num_lights + 1]
    in_rr = bounce >= cfg.max_depth
    survival = jnp.clip(brdf.luminance(throughput), 0.1, 1.0)
    died = active & in_rr & (u_rr > survival)
    if cfg.sky_always:
        # Reference adds sky * throughput on *every* exit (glsl:292).
        color = color + jnp.where(
            bc(died), throughput * _sky(dirs, cfg), 0.0
        )
    survived = active & ~died
    throughput = jnp.where(
        bc(survived & in_rr), throughput / bc(survival),
        throughput,
    )
    active = survived

    # --- Indirect bounce (glsl:276-285) ---
    u4 = u[2 * num_lights + 2:2 * num_lights + 6]
    new_dir, weight, valid = brdf.sample_indirect(
        rec.p, rec.normal, view, rec.mat, take_spec,
        u4[0], u4[1], u4[2], u4[3],
    )
    invalid = active & ~valid
    if cfg.sky_always:
        color = color + jnp.where(
            bc(invalid), throughput * _sky(dirs, cfg), 0.0
        )
    cont = active & valid
    throughput = jnp.where(bc(cont), throughput * weight, throughput)
    origins = jnp.where(bc(cont), rec.p, origins)
    dirs = jnp.where(bc(cont), new_dir, dirs)
    if nee_on:
        # Mixture pdf of the direction just sampled — the NEXT bounce's
        # hit-side MIS weight.  Delta-specular choices (roughness 0:
        # perfect-mirror fast path) carry the sentinel (weight -> 1).
        _, pdf_next = brdf.eval_lobes_pdf(rec.normal, view, new_dir,
                                          rec.mat, h_diffuse=h_rand)
        delta_choice = take_spec & (rec.mat.roughness == 0.0)
        prev_pdf = jnp.where(cont & ~delta_choice, pdf_next, _NO_MIS_PDF)
    if cone is not None:
        # Ray-cone update: the footprint grows along the segment, the
        # spread widens by the sampled lobe (specular by roughness,
        # diffuse by a constant — Akenine-Moller-style ray cones without
        # the curvature term).
        t_seg = jnp.where(rec.hit, rec.t, 0.0)
        cwidth = jnp.where(cont, cwidth + t_seg * cspread, cwidth)
        dspread = jnp.where(take_spec,
                            cfg.cone_spec_spread * rec.mat.roughness,
                            cfg.cone_diffuse_spread)
        cspread = jnp.where(cont, cspread + dspread, cspread)
    # Per-bounce ray accounting: closest-hit rays entering the bounce +
    # shadow rays for paths that found a hit (for Mrays/s metrics).
    # Accounting: closest-hit rays entering the bounce + shadow QUERIES
    # issued for active-hit paths.  The integrator's workload per frame
    # is fixed by (scene, camera, depth); a shadow query whose answer
    # multiplies an exact zero (NdotL/RIS mask above) is RESOLVED
    # analytically instead of traced — it stays in the count the same
    # way early-out-resolved rays do, and the saving shows up where it
    # belongs: in the frame time.  (Padding lanes are still never
    # counted.)  Mask measured r5: 13% of headline shadow queries, -11%
    # frame time, image bit-identical.
    shadow_queries = jnp.sum(active)
    if nee_on:
        shadow_queries = shadow_queries + jnp.sum(nee_active)
    stats = jnp.stack([jnp.sum(alive), shadow_queries])
    if sort:
        # Re-pack the wavefront for the next bounce (see
        # _bounce_sort_keys); one stable u32 argsort per bounce.
        # The permutation is applied as ONE row gather on a packed
        # [N, 14] array instead of one gather per component-first
        # [3, N] carry.
        order = jnp.argsort(
            _bounce_sort_keys(origins, dirs, cont, bounce), stable=True)
        extra = [] if cone is None else [cwidth[None], cspread[None]]
        if nee_on:
            extra = extra + [prev_pdf[None]]
        packed = jnp.concatenate([
            origins, dirs, throughput, color,
            cont[None].astype(jnp.float32),
            # pix < 2^24 stays exact in f32.
            pix[None].astype(jnp.float32),
        ] + extra, axis=0).T[order].T
        origins, dirs = packed[0:3], packed[3:6]
        throughput, color = packed[6:9], packed[9:12]
        cont = packed[12] > 0.5
        pix = packed[13].astype(jnp.int32)
        kk = 14
        if cone is not None:
            cwidth, cspread = packed[kk], packed[kk + 1]
            kk += 2
        if nee_on:
            prev_pdf = packed[kk]
    out_carry = (origins, dirs, throughput, color, cont, pix)
    if cone is not None:
        out_carry = out_carry + (cwidth, cspread)
    if nee_on:
        out_carry = out_carry + (prev_pdf,)
    if return_aux:
        assert not sort, "return_aux reports pre-sort order; use sort=False"
        return out_carry, stats, {
            "take_spec": take_spec, "rough": rec.mat.roughness,
            "hit": rec.hit, "t": rec.t,
        }
    return out_carry, stats


def trace_wavefront(closest_hit: HitFn, lights: Lights, origins, dirs,
                    stream, cfg: RenderConfig, return_stats: bool = False,
                    shadow_fn=None, emitters=None):
    """Trace an ``[3, N]`` ray batch to radiance ``[3, N]``.

    ``stream`` is a KeyStream/ArrayStream; slots are consumed in the
    documented per-bounce order (ops/rng.py) so the numpy oracle can replay
    the exact same randomness.

    The bounce loop is a ``lax.scan`` over pre-drawn per-bounce uniforms —
    one traced bounce body regardless of depth, which keeps XLA compile
    time flat as ``max_depth + rr_bounces`` grows (the reference's
    ``while(true)`` at raytrace_compute.glsl:224 has no such concern
    because GLSL compiles per-thread scalar code).
    """
    n = origins.shape[1]
    num_lights = lights.count
    n_bounces = cfg.max_depth + cfg.rr_bounces
    nee_on = emitters is not None and cfg.nee
    from srt_tpu.ops.rng import bounce_slots
    d_slots = bounce_slots(num_lights, nee_on)

    # [B*D, N] drawn in slot order -> [B, D, N] per-bounce blocks (the
    # slot-major stream layout makes this reshape free).
    u_all = stream.take(n_bounces * d_slots)
    u_bounce = u_all.reshape(n_bounces, d_slots, n)

    def bounce_body(carry, inputs):
        bounce, u = inputs
        if cfg.sort_bounces:
            # The wavefront is in sorted-ray order; uniforms are drawn in
            # pixel order, so gather each ray's slots via the position ->
            # pixel map.  Every pixel consumes exactly the same numbers as
            # in unsorted order — the image is bit-identical (tested).
            # Row-major gather (see the note in bounce_step).
            u = u.T[carry[5]].T
        return bounce_step(closest_hit, lights, cfg, carry, bounce, u,
                           sort=cfg.sort_bounces, shadow_fn=shadow_fn,
                           emitters=emitters)

    init = (
        origins,
        dirs,
        jnp.ones((3, n), jnp.float32),
        jnp.zeros((3, n), jnp.float32),
        jnp.ones((n,), bool),
        jnp.arange(n, dtype=jnp.int32),
    )
    if cfg.ray_cones:
        init = init + (jnp.zeros((n,), jnp.float32),
                       jnp.full((n,), cfg.primary_spread, jnp.float32))
    if nee_on:
        # Primary rays carry the no-MIS sentinel: emitters seen directly
        # keep full credit.
        init = init + (jnp.full((n,), _NO_MIS_PDF, jnp.float32),)
    out_carry, stats = jax.lax.scan(
        bounce_body, init, (jnp.arange(n_bounces), u_bounce)
    )
    origins, dirs, throughput, color, alive, pix = out_carry[:6]

    # Paths that survive the static loop are truncated as a miss.
    color = color + jnp.where(bc(alive), throughput * _sky(dirs, cfg), 0.0)
    if cfg.sort_bounces:
        # Scatter radiance back to pixel order.
        color = jnp.zeros_like(color).at[:, pix].set(color)
    if return_stats:
        return color, stats  # stats: [B, 2] = (trace rays, shadow rays)
    return color


def trace_image_sample(closest_hit: HitFn, lights: Lights,
                       cam: CameraConfig, cfg: RenderConfig, stream,
                       origin=None, look_at=None,
                       return_stats: bool = False) -> jnp.ndarray:
    """One full-image sample: jittered primary rays + wavefront trace.
    Returns linear radiance [H, W, 3] (+ the [B, 2] ray stats with
    ``return_stats``)."""
    if cfg.ray_cones and cfg.primary_spread == 0.0:
        # One-pixel footprint per unit t at the reference viewport
        # (1x1 at focus_dist; camera.derive_viewport).
        import dataclasses
        cfg = dataclasses.replace(
            cfg, primary_spread=1.0 / (cam.focus_dist
                                       * min(cam.width, cam.height)))
    vp = derive_viewport(cam, origin=origin, look_at=look_at)
    jitter = stream.take(2)
    # Defocus slots are drawn only when depth of field is on, keeping the
    # base slot protocol unchanged for oracle comparisons.
    defocus = stream.take(2) if cam.defocus_angle > 0 else None
    origins, dirs = generate_rays(vp, cam.width, cam.height, jitter, defocus)
    stats = None
    if cfg.morton_order:
        # Z-order the wavefront for tile coherence (ops/morton.py); the
        # stream is permuted identically so the image is bit-identical.
        from srt_tpu.ops.morton import (PermutedStream, morton_perm,
                                        permute_rays, unpermute_image)
        perm, inv = morton_perm(cam.height, cam.width)
        origins, dirs = permute_rays(origins, dirs, perm)
        out = trace_wavefront(
            closest_hit, lights, origins, dirs, PermutedStream(stream, perm),
            cfg, return_stats=return_stats,
        )
        if return_stats:
            out, stats = out
        radiance = unpermute_image(out, inv)
    else:
        out = trace_wavefront(
            closest_hit, lights, origins, dirs, stream, cfg,
            return_stats=return_stats,
        )
        if return_stats:
            out, stats = out
        radiance = out
    img = radiance.T.reshape(cam.height, cam.width, 3)
    if return_stats:
        return img, stats
    return img


def render(closest_hit: HitFn, lights: Lights, cam: CameraConfig,
           cfg: RenderConfig, key: jax.Array,
           origin=None, look_at=None) -> jnp.ndarray:
    """Render ``cfg.spp`` accumulated samples; linear mean image [H, W, 3].

    The progressive-accumulation analog (raytrace_compute.glsl:404-406) for
    offline use; the interactive session in srt_tpu.app accumulates frame by
    frame instead.
    """
    n = cam.height * cam.width

    def one_sample(s):
        stream = KeyStream(jax.random.fold_in(key, s), n)
        return trace_image_sample(
            closest_hit, lights, cam, cfg, stream, origin=origin, look_at=look_at
        )

    if cfg.spp == 1:
        return one_sample(0)
    acc = jax.lax.map(one_sample, jnp.arange(cfg.spp))
    return jnp.mean(acc, axis=0)


def render_spheres(spheres: Spheres, lights: Lights, cam: CameraConfig,
                   cfg: RenderConfig, key: jax.Array) -> jnp.ndarray:
    """Convenience: render a sphere scene (the SHOW_MODEL=0 configuration)."""
    return render(spheres_hit_fn(spheres), lights, cam, cfg, key)


def trace_with_uniforms(closest_hit: HitFn, lights: Lights,
                        cam: CameraConfig, cfg: RenderConfig,
                        uniforms) -> jnp.ndarray:
    """One image sample driven by an injected ``[N, D]`` uniform array —
    the oracle-comparison entry point (same slots as the numpy oracle)."""
    return trace_image_sample(closest_hit, lights, cam, cfg, ArrayStream(uniforms))
