"""GGX microfacet BRDF library, batched over ray wavefronts.

Wavefront rewrite of shaders/brdf.glsl + the shading helpers in
shaders/raytrace_utils.glsl: Cook-Torrance GGX with Smith height-correlated
masking, Schlick Fresnel, cosine-weighted diffuse + GGX half-vector sampling,
RIS (resampled importance sampling) over point lights, and the lobe-selection
probability.  Vectors are component-first ``[3, N]`` and per-ray scalars are
``[N]`` (the wavefront layout, ops/vec.py); everything is differentiable
w.r.t. material parameters, geometry and light parameters.

Reference quirks deliberately fixed (see SURVEY.md "quirks" list):
* ``EvalSpecular`` passed ``(alphaSquared, NdotH)`` into the NDF with swapped
  arguments (brdf.glsl:140 vs :15) — we call it correctly.
* ``SampleLights``'s random index used ``round(u * lightCount)`` which can
  index one past the end (raytrace_compute.glsl:186) — we floor and clamp.
* ``V`` is normalized here; the reference used the unnormalized
  ``-ray.direction`` (raytrace_compute.glsl:231) which skews dot products
  for primary rays.

All min/max epsilon clamps mirror the reference so renderer and oracle agree
bit-for-bit in spirit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from srt_tpu.ops import vec
from srt_tpu.ops.safemath import safe_sqrt
from srt_tpu.ops.vec import bc, dot
from srt_tpu.scene import Lights, Materials

PI = 3.14159265358979323846
MIN_DIELECTRIC_F0 = 0.04


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def luminance(rgb):
    """BT.709 relative luminance (raytrace_utils.glsl:107-109).
    rgb: [3, N] -> [N]."""
    return 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]


def specular_f0(base_color, metalness):
    """Metalness mix of dielectric F0 (raytrace_utils.glsl:111-113)."""
    m = bc(metalness)
    return (1.0 - m) * MIN_DIELECTRIC_F0 + m * base_color


def shadowed_f90(f0):
    """F90 derived from F0 luminance (raytrace_utils.glsl:131-137)."""
    return jnp.minimum(1.0, (1.0 / MIN_DIELECTRIC_F0) * luminance(f0))


def fresnel_schlick(f0, f90, n_dot_s):
    """``FresnelSchlickNew`` (brdf.glsl:39-41). f0 [3, N]; f90/n_dot_s [N]."""
    return f0 + (bc(f90) - f0) * jnp.power(1.0 - bc(n_dot_s), 5.0)


def ggx_ndf(n_dot_h, alpha_squared):
    """``ggxNormalDistributionNew`` (brdf.glsl:15-18) with the arguments in
    the *correct* order (the reference call site swapped them)."""
    b = (alpha_squared - 1.0) * n_dot_h * n_dot_h + 1.0
    return alpha_squared / jnp.maximum(0.001, PI * b * b)


def smith_g_alpha(alpha, n_dot_s):
    """``SmithGAlpha`` (brdf.glsl:44-46)."""
    return n_dot_s / (
        jnp.maximum(1e-4, alpha)
        * jnp.sqrt(1.0 - jnp.minimum(0.99999, n_dot_s * n_dot_s))
    )


def smith_g_lambda_ggx(a):
    """``SmithGLambdaGGX`` (brdf.glsl:48-50)."""
    return (-1.0 + jnp.sqrt(1.0 + 1.0 / jnp.maximum(0.001, a * a))) * 0.5


def smith_g2_height_correlated(alpha, n_dot_l, n_dot_v):
    """``Smith_G2_Height_Correlated`` (brdf.glsl:53-57)."""
    a_l = smith_g_alpha(alpha, n_dot_l)
    a_v = smith_g_alpha(alpha, n_dot_v)
    return 1.0 / (1.0 + smith_g_lambda_ggx(a_l) + smith_g_lambda_ggx(a_v))


def ggx_schlick_masking(n_dot_l, n_dot_v, roughness):
    """Legacy Schlick-GGX masking (brdf.glsl:21-31) used by the ``useSpec``
    direct-light path (``SampleDirect``)."""
    k = roughness * roughness / 2.0
    g_v = n_dot_v / jnp.maximum(0.001, n_dot_v * (1.0 - k) + k)
    g_l = n_dot_l / jnp.maximum(0.001, n_dot_l * (1.0 - k) + k)
    return jnp.abs(g_v * g_l)


def ggx_ndf_legacy(n_dot_h, roughness):
    """Legacy NDF with alpha = roughness^2 (brdf.glsl:8-12)."""
    a2 = roughness * roughness
    d = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0
    return a2 / jnp.maximum(0.001, d * d * PI)


def schlick_fresnel_legacy(f0, u):
    """Legacy Schlick (brdf.glsl:34-36). f0 [3, N]; u [N]."""
    return f0 + (1.0 - f0) * jnp.power(jnp.maximum(0.001, 1.0 - bc(u)), 5.0)


def probability_to_sample_diffuse(diff_brdf, spec_brdf):
    """Luminance-ratio lobe probability (``probabilityToSampleDiffuse``,
    raytrace_utils.glsl:115-119; used by the reference's legacy sampler)."""
    lum_d = jnp.maximum(0.01, luminance(diff_brdf))
    lum_s = jnp.maximum(0.01, luminance(spec_brdf))
    return lum_d / (lum_d + lum_s)


def perpendicular_vector(u):
    """Branchless perpendicular basis vector (raytrace_utils.glsl:123-129).
    u: [3, N]."""
    a = jnp.abs(u)
    xm = ((a[0] - a[1]) < 0) & ((a[0] - a[2]) < 0)
    xm = xm.astype(u.dtype)
    ym = jnp.where((a[1] - a[2]) < 0, 1.0 - xm, 0.0)
    zm = (1.0 - xm) * (1.0 - ym)
    axis = jnp.stack([xm, ym, zm])
    return vec.cross(u, axis)


def reflect(incident, normal):
    """GLSL ``reflect``: I - 2*dot(N, I)*N."""
    return incident - 2.0 * bc(dot(normal, incident)) * normal


def sample_diffuse(normal, r1, r2):
    """Cosine-weighted hemisphere sample around ``normal``
    (``SampleDiffuse``, brdf.glsl:60-74). r1/r2: [N] uniforms."""
    bitangent = perpendicular_vector(normal)
    tangent = vec.cross(bitangent, normal)
    # safe_sqrt: r1 of exactly 0/1 would otherwise give inf derivatives.
    r = safe_sqrt(jnp.abs(r1))
    phi = 2.0 * PI * r2
    return (
        tangent * bc(r * jnp.cos(phi))
        + bitangent * bc(r * jnp.sin(phi))
        + normal * bc(safe_sqrt(jnp.abs(1.0 - r1)))
    )


def sample_ggx_half_vector(normal, roughness, r1, r2):
    """GGX NDF half-vector sample (``SampleSpecularHalfVec``,
    brdf.glsl:81-99).  Note the reference uses a2 = roughness^2 here."""
    b = perpendicular_vector(normal)
    t = vec.cross(b, normal)
    a2 = roughness * roughness
    # safe_sqrt throughout: as roughness -> 0, cos_th rounds to exactly 1
    # in fp32 and the plain sqrt's infinite derivative at 0 NaNs roughness
    # gradients (the sample itself is fine).
    cos_th = safe_sqrt(jnp.maximum(0.0, (1.0 - r1) / ((a2 - 1.0) * r1 + 1.0)))
    sin_th = safe_sqrt(jnp.maximum(0.0, 1.0 - cos_th * cos_th))
    phi = r2 * 2.0 * PI
    return (
        t * bc(sin_th * jnp.cos(phi))
        + b * bc(sin_th * jnp.sin(phi))
        + normal * bc(cos_th)
    )


def specular_sample_weight(alpha_squared, n_dot_s):
    """Sample weight = G2/G1 shortcut (``SpecularSampleWeight``,
    brdf.glsl:76-78)."""
    s2 = n_dot_s * n_dot_s
    return 2.0 / (jnp.sqrt((alpha_squared * (1.0 - s2) + s2) / s2) + 1.0)


class BrdfData(NamedTuple):
    """``BrdfData`` (raytrace_types.glsl) — precomputed dots and material
    terms (``GetAllBRDFValues``, brdf.glsl:173-198)."""

    n_dot_l: jnp.ndarray
    n_dot_v: jnp.ndarray
    l_dot_h: jnp.ndarray
    n_dot_h: jnp.ndarray
    v_dot_h: jnp.ndarray
    specular_f0: jnp.ndarray
    diffuse_reflectance: jnp.ndarray
    roughness: jnp.ndarray
    alpha: jnp.ndarray
    alpha_squared: jnp.ndarray
    fresnel: jnp.ndarray


def brdf_data(normal, light_dir, view_dir, mat: Materials) -> BrdfData:
    """Vectorized ``GetAllBRDFValues`` (brdf.glsl:173-198)."""
    h = vec.normalize(light_dir + view_dir)
    n_dot_l = saturate(dot(normal, light_dir))
    n_dot_v = saturate(dot(normal, view_dir))
    l_dot_h = saturate(dot(light_dir, h))
    n_dot_h = saturate(dot(normal, h))
    v_dot_h = saturate(dot(view_dir, h))
    f0 = specular_f0(mat.albedo, mat.metalness)
    alpha = mat.roughness * mat.roughness
    return BrdfData(
        n_dot_l=n_dot_l,
        n_dot_v=n_dot_v,
        l_dot_h=l_dot_h,
        n_dot_h=n_dot_h,
        v_dot_h=v_dot_h,
        specular_f0=f0,
        diffuse_reflectance=mat.albedo * bc(1.0 - mat.metalness),
        roughness=mat.roughness,
        alpha=alpha,
        alpha_squared=alpha * alpha,
        fresnel=fresnel_schlick(f0, shadowed_f90(f0), l_dot_h),
    )


def eval_diffuse(data: BrdfData):
    """``EvalDiffuse`` (brdf.glsl:134-137)."""
    return data.diffuse_reflectance * bc(data.n_dot_l / PI)


def eval_specular(data: BrdfData):
    """``EvalSpecular`` (brdf.glsl:139-145), NDF args fixed."""
    d = ggx_ndf(data.n_dot_h, jnp.maximum(1e-5, data.alpha_squared))
    g = smith_g2_height_correlated(data.alpha, data.n_dot_l, data.n_dot_v)
    denom = 4.0 * jnp.maximum(data.n_dot_l, 0.001) * jnp.maximum(data.n_dot_v, 0.001)
    scale = g * d / jnp.maximum(denom, 0.001) * data.n_dot_l
    return data.fresnel * bc(scale)


def light_falloff(p, light_pos):
    """Inverse-square falloff with near-field clamp
    (``GetLightFalloff``, brdf.glsl:147-152). p [3, N]; light_pos [3, N] or
    [3, 1]."""
    d = light_pos - p
    return 1.0 / (0.01 * 0.01 + dot(d, d))


def light_dir_to(p, light_pos):
    """``getLightData`` (brdf.glsl:2-5): unit vector to the light."""
    return vec.normalize(light_pos - p)


def sample_direct(p, normal, view_dir, mat: Materials, light_pos, light_color,
                  light_intensity, shadow_mult):
    """Legacy direct-light evaluator for ``useSpec`` materials
    (``SampleDirect``, brdf.glsl:200-224): Cook-Torrance with the legacy
    NDF/masking/Fresnel and NdotL cancelled against the sampling PDF."""
    l_dir = light_dir_to(p, light_pos)
    h = vec.normalize(view_dir + l_dir)
    n_dot_l = saturate(dot(normal, l_dir))
    n_dot_h = saturate(dot(normal, h))
    l_dot_h = saturate(dot(l_dir, h))
    n_dot_v = saturate(dot(normal, view_dir))
    d = ggx_ndf_legacy(n_dot_h, mat.roughness)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(mat.specular, l_dot_h)
    falloff = light_falloff(p, light_pos)
    intensity = light_intensity * falloff
    ggx_term = f * bc(d * g / (4.0 * jnp.maximum(0.001, n_dot_v)))
    light_term = bc(shadow_mult) * light_color * bc(intensity)
    return light_term * (ggx_term + bc(n_dot_l) * mat.albedo / PI)


def sample_direct_new(normal, light_dir, view_dir, mat: Materials):
    """Energy-conserving direct evaluator for non-``useSpec`` materials
    (``SampleDirectNew``, brdf.glsl:226-237): (1 - F) * diffuse + specular.
    The caller multiplies by shadow, light color/intensity/falloff and the
    RIS weight (raytrace_compute.glsl:242-244)."""
    data = brdf_data(normal, light_dir, view_dir, mat)
    return (1.0 - data.fresnel) * eval_diffuse(data) + eval_specular(data)


def brdf_probability(mat: Materials, view_dir, normal):
    """Specular-lobe selection probability (``GetBrdfProbability``,
    brdf.glsl:279-288), clamped to [0.1, 0.9]."""
    spec_f0_lum = luminance(specular_f0(mat.albedo, mat.metalness))
    diff_lum = luminance(mat.albedo * bc(1.0 - mat.metalness))
    f0 = jnp.broadcast_to(bc(spec_f0_lum), (3,) + spec_f0_lum.shape)
    fres = saturate(
        luminance(
            fresnel_schlick(
                f0, shadowed_f90(f0), jnp.maximum(0.0, dot(view_dir, normal))
            )
        )
    )
    spec = fres
    diff = diff_lum * (1.0 - fres)
    p = spec / jnp.maximum(1e-4, spec + diff)
    return jnp.clip(p, 0.1, 0.9)


def sample_specular_microfacet(p, normal, view_dir, mat: Materials, f0,
                               alpha, alpha_squared, h_r1, h_r2):
    """GGX importance sample + weight (``SampleSpecularMicrofacet``,
    brdf.glsl:102-132).  Returns (direction [3, N], weight [3, N])."""
    # Perfect-mirror fast path when alpha == 0 (brdf.glsl:106-110).
    l_perfect = reflect(-view_dir, normal)
    # Half vector = normalize(V + L) — both pointing away from the
    # surface.  (r1-r4 had normalize(-V + L), which is TANGENT to the
    # surface for a perfect mirror: every roughness-0 bounce then
    # reflected INTO the surface and died as invalid.  The numpy oracle
    # carried the same sign, so parity tests never saw it; no scene used
    # roughness exactly 0 until the reflected-silhouette work.)
    h_perfect = vec.normalize(view_dir + l_perfect, fallback=normal)
    h_sampled = sample_ggx_half_vector(normal, mat.roughness, h_r1, h_r2)
    h = jnp.where(bc(alpha == 0.0), h_perfect, h_sampled)

    l_dir = reflect(-view_dir, h)
    h_dot_l = jnp.clip(dot(h, l_dir), 1e-5, 1.0)
    n_dot_l = jnp.clip(dot(normal, l_dir), 1e-5, 1.0)
    f = fresnel_schlick(f0, shadowed_f90(f0), h_dot_l)
    weight = f * bc(specular_sample_weight(alpha_squared, n_dot_l))
    return l_dir, weight


def sample_indirect(p, normal, view_dir, mat: Materials, take_specular,
                    diff_r1, diff_r2, h_r1, h_r2):
    """Next-bounce direction + throughput weight (``SampleIndirectNew``,
    brdf.glsl:239-277).

    ``take_specular``: [N] bool lobe choice (made by the caller from
    ``brdf_probability``).  Returns (direction [3, N], weight [3, N],
    valid [N]).  Invalid when the view is below the surface, the weight is
    black, or the sampled direction is below the surface.
    """
    above = dot(normal, view_dir) > 0.0

    # Diffuse branch (brdf.glsl:248-260).
    diff_dir = sample_diffuse(normal, diff_r1, diff_r2)
    data = brdf_data(normal, diff_dir, view_dir, mat)
    h = sample_ggx_half_vector(normal, mat.roughness, h_r1, h_r2)
    v_dot_h = jnp.clip(dot(view_dir, h), 1e-5, 1.0)
    diff_weight = data.diffuse_reflectance * (
        1.0 - fresnel_schlick(data.specular_f0, shadowed_f90(data.specular_f0), v_dot_h)
    )

    # Specular branch (brdf.glsl:261-264).
    spec_dir, spec_weight = sample_specular_microfacet(
        p, normal, view_dir, mat, data.specular_f0, data.alpha,
        data.alpha_squared, h_r1, h_r2,
    )

    raw_dir = jnp.where(bc(take_specular), spec_dir, diff_dir)
    weight = jnp.where(bc(take_specular), spec_weight, diff_weight)

    direction = vec.normalize(raw_dir)
    valid = (
        above
        & (luminance(weight) != 0.0)
        & (dot(normal, direction) > 0.0)
    )
    return direction, weight, valid


def eval_lobes_pdf(normal, view_dir, direction, mat: Materials,
                   h_diffuse=None):
    """Implied-BRDF integrand + one-sample-mixture pdf of
    ``sample_indirect`` at an arbitrary ``direction`` (r5 NEE/MIS; a
    capability the reference lacks — it parses Ke but never lights with
    it, model_loader.cpp:240-273).

    Returns ``(fcos [3, N], pdf_mix [N])``:

    * ``fcos`` is the radiance-transport integrand the indirect
      estimator *implies* — per-lobe ``weight(direction) *
      pdf_lobe(direction)`` summed over lobes, with the lobe weights
      exactly ``sample_indirect``'s — so next-event estimation and BSDF
      sampling estimate the SAME integral and their MIS combination is
      consistent.
    * ``pdf_mix`` is the marginal solid-angle density of the
      specular-probability lobe mixture (``brdf_probability``), for
      balance-heuristic MIS weights.

    ``h_diffuse``: the GGX half-vector sample whose Fresnel the diffuse
    lobe weight uses (``sample_indirect`` draws one per bounce); pass
    the SAME sample for an exact estimator match — any
    distribution-identical sample keeps the combination unbiased in
    expectation.  The roughness-0 specular lobe is a delta: its pdf and
    fcos contributions are 0 here (an area sample cannot hit a delta;
    the hit-side MIS weight covers it via the BIG-pdf sentinel in
    models/pathtracer.bounce_step)."""
    p_spec = brdf_probability(mat, view_dir, normal)
    n_dot_l = saturate(dot(normal, direction))
    pdf_diff = n_dot_l / PI

    h = vec.normalize(view_dir + direction, fallback=normal)
    n_dot_h = saturate(dot(normal, h))
    v_dot_h = jnp.clip(dot(view_dir, h), 1e-5, 1.0)
    # The sampler's NDF parameter is roughness^2 (= BrdfData.alpha;
    # sample_ggx_half_vector, brdf.glsl:81-99) — NOT alpha_squared.
    data = brdf_data(normal, direction, view_dir, mat)
    nd = ggx_ndf(n_dot_h, data.alpha)
    live_spec = data.alpha > 0.0
    pdf_spec = jnp.where(live_spec, nd * n_dot_h / (4.0 * v_dot_h), 0.0)

    f0 = data.specular_f0
    h_dot_l = jnp.clip(dot(h, direction), 1e-5, 1.0)
    w_spec = fresnel_schlick(f0, shadowed_f90(f0), h_dot_l) * bc(
        specular_sample_weight(
            data.alpha_squared, jnp.clip(dot(normal, direction), 1e-5, 1.0))
    )
    if h_diffuse is None:
        h_diffuse = h
    vdh_d = jnp.clip(dot(view_dir, h_diffuse), 1e-5, 1.0)
    w_diff = data.diffuse_reflectance * (
        1.0 - fresnel_schlick(f0, shadowed_f90(f0), vdh_d))

    fcos = w_spec * bc(pdf_spec) + w_diff * bc(pdf_diff)
    pdf_mix = p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff
    return fcos, pdf_mix


def sample_lights_ris(p, lights: Lights, u_idx, u_sel):
    """Resampled importance sampling over point lights (``SampleLights``,
    raytrace_compute.glsl:179-206).

    p: [3, N] shading points; u_idx/u_sel: [L, N] uniforms.
    Runs L reservoir iterations: random light index per iteration,
    RIS weight = luminance(intensity * falloff) * L, streaming selection.
    Returns (selected [N] bool, light_idx [N] int32, weight [N]).
    The off-by-one ``round(u * L)`` indexing bug is fixed with
    floor + clamp.
    """
    n = p.shape[1]
    num_lights = lights.count
    total = jnp.zeros((n,), p.dtype)
    sel_idx = jnp.zeros((n,), jnp.int32)
    sel_pdf = jnp.zeros((n,), p.dtype)
    selected = jnp.zeros((n,), bool)

    # Per-light pdf = intensity * falloff, computed once for all L lights
    # with no gathers (see ops/gather.py).  The reservoir loop then selects by index with
    # cheap where-chains.
    pdf_k = [
        lights.intensity[k] * light_falloff(p, vec.col(lights.position[k]))
        for k in range(num_lights)
    ]

    def pdf_at(cand):
        out = pdf_k[0]
        for k in range(1, num_lights):
            out = jnp.where(cand == k, pdf_k[k], out)
        return out

    for i in range(num_lights):
        cand = jnp.clip(
            jnp.floor(u_idx[i] * num_lights).astype(jnp.int32), 0, num_lights - 1
        )
        # luminance of a grey vec3(intensity) is just intensity
        light_pdf = pdf_at(cand)
        ris_w = light_pdf * num_lights
        total = total + ris_w
        accept = u_sel[i] < jnp.where(total > 0.0, ris_w / jnp.where(total > 0.0, total, 1.0), 0.0)
        sel_idx = jnp.where(accept, cand, sel_idx)
        sel_pdf = jnp.where(accept, light_pdf, sel_pdf)
        selected = selected | accept

    weight = (total / num_lights) / jnp.maximum(0.001, sel_pdf)
    return selected, sel_idx, weight


# ---------------------------------------------------------------------------
# Legacy sampler tail (brdf.glsl:290-386) — the reference keeps a second,
# partially-used BRDF/PDF set alongside the "New" path.  Re-implemented for
# inventory parity, batched over [3, N] wavefronts, with the hash-RNG draws
# replaced by explicit uniform arguments (ops/rng.py slot discipline) and
# the half-vector passed explicitly where the reference re-SAMPLES a random
# one inside an evaluator (SpecularPDF/SpecularBRDF, brdf.glsl:326/341 — a
# documented quirk we deliberately do not reproduce; see SURVEY.md).
# ---------------------------------------------------------------------------

def legacy_diffuse_pdf(normal, light_dir):
    """``DiffusePDF`` (brdf.glsl:320-322): cosine-hemisphere pdf."""
    return jnp.maximum(dot(normal, light_dir), 0.0) / PI


def legacy_specular_pdf(normal, half_vec, light_dir, roughness):
    """``SpecularPDF`` (brdf.glsl:324-334) with the half-vector passed in:
    GGX NDF pdf transformed to light direction, D*NdotH / (4*LdotH)."""
    l_dot_h = saturate(dot(light_dir, half_vec))
    n_dot_h = saturate(dot(normal, half_vec))
    d = ggx_ndf_legacy(n_dot_h, roughness)
    return d * n_dot_h / jnp.maximum(4.0 * l_dot_h, 1e-4)


def legacy_diffuse_brdf(mat: Materials):
    """``DiffuseBRDF`` (brdf.glsl:336-338): albedo / pi."""
    return mat.albedo / PI


def legacy_specular_brdf(normal, view_dir, light_dir, mat: Materials):
    """``SpecularBRDF`` (brdf.glsl:340-358) with H = normalize(V + L)
    (the expression the reference comments out in favor of a fresh random
    half-vector): legacy D * Schlick-G * F / (4 NdotV NdotL)."""
    h = vec.normalize(view_dir + light_dir)
    n_dot_l = saturate(dot(normal, light_dir))
    n_dot_h = saturate(dot(normal, h))
    l_dot_h = saturate(dot(light_dir, h))
    n_dot_v = saturate(dot(normal, view_dir))
    d = ggx_ndf_legacy(n_dot_h, mat.roughness)
    g = ggx_schlick_masking(n_dot_l, n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(mat.specular, l_dot_h)
    denom = 4.0 * jnp.maximum(n_dot_v, 0.001) * jnp.maximum(n_dot_l, 0.001)
    return f * bc(d * g / jnp.maximum(denom, 0.001))


def legacy_brdf(normal, in_dir, out_dir, mat: Materials, is_diffuse):
    """``BRDF`` (brdf.glsl:360-386): per-lobe evaluator — cosine-weighted
    Lambertian for the diffuse lobe, D*G*F/(4 NdotV) for the specular lobe
    (the reference comments out the NdotL factor; matched)."""
    data = brdf_data(normal, out_dir, -in_dir, mat)
    d = ggx_ndf_legacy(data.n_dot_h, mat.roughness)
    g = ggx_schlick_masking(data.n_dot_l, data.n_dot_v, mat.roughness)
    f = schlick_fresnel_legacy(specular_f0(mat.albedo, mat.metalness),
                               data.l_dot_h)
    ggx_term = f * bc(d * g / jnp.maximum(4.0 * data.n_dot_v, 0.001))
    diffuse_term = mat.albedo * bc(data.n_dot_l / PI)
    return jnp.where(bc(is_diffuse), diffuse_term, ggx_term)


def legacy_sample_next_ray(p, normal, in_dir, mat: Materials,
                           u_lobe, u1, u2):
    """``SampleNextRay`` (brdf.glsl:290-318): luminance-ratio lobe choice,
    cosine diffuse or GGX half-vector specular bounce, with the matching
    pdf.  Returns (direction [3, N], pdf [N], is_diffuse [N] bool).
    Uniform draws are explicit arguments (u_lobe/u1/u2 [N])."""
    diff_prob = probability_to_sample_diffuse(
        legacy_diffuse_brdf(mat),
        legacy_specular_brdf(normal, -in_dir, reflect(in_dir, normal), mat),
    )
    is_diffuse = u_lobe < diff_prob

    l_diff = sample_diffuse(normal, u1, u2)
    half = sample_ggx_half_vector(normal, mat.roughness, u1, u2)
    l_spec = reflect(in_dir, half)

    direction = jnp.where(bc(is_diffuse), l_diff, l_spec)
    pdf_diff = legacy_diffuse_pdf(normal, l_diff)
    pdf_spec = legacy_specular_pdf(normal, half, l_spec, mat.roughness)
    pdf = jnp.where(is_diffuse, pdf_diff, pdf_spec)
    return direction, pdf, is_diffuse
