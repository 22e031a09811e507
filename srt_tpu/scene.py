"""Scene pytrees: materials, spheres, point lights, and the default scenes.

Everything is structure-of-arrays so a whole scene is a single pytree of
device arrays — the device-side replacement for the reference's in-kernel
hard-coded sphere/material table (shaders/raytrace_compute.glsl:299-364) and
the host-side light rigs (src/main.cpp:580-595).  Because scenes are pytrees,
they are differentiable: gradients flow from pixel losses into sphere
centers/radii, material coefficients, and light parameters.
"""

from __future__ import annotations

import chex
import jax.numpy as jnp
import numpy as np


@chex.dataclass(frozen=True)
class Materials:
    """Shading materials, SoA over the material dimension.

    Mirrors the GLSL ``Material`` struct (shaders/raytrace_types.glsl) —
    albedo/specular color, GGX roughness, metalness, and the ``useSpec``
    flag that selects between the two direct-light evaluators
    (raytrace_compute.glsl:238-245).
    """

    albedo: jnp.ndarray     # [M, 3]
    specular: jnp.ndarray   # [M, 3]
    roughness: jnp.ndarray  # [M]
    metalness: jnp.ndarray  # [M]
    use_spec: jnp.ndarray   # [M] bool

    def take(self, idx: jnp.ndarray) -> "Materials":
        """Per-ray materials by index (idx: [N] -> fields [N, ...]).
        Select-chain for small tables; real gather past the limit
        (ops/gather.py)."""
        from srt_tpu.ops.gather import take_small
        return Materials(
            albedo=take_small(self.albedo, idx),
            specular=take_small(self.specular, idx),
            roughness=take_small(self.roughness, idx),
            metalness=take_small(self.metalness, idx),
            use_spec=take_small(self.use_spec, idx),
        )

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


@chex.dataclass(frozen=True)
class Spheres:
    """Sphere primitives (reference ``Sphere``, raytrace_types.glsl)."""

    center: jnp.ndarray  # [S, 3]
    radius: jnp.ndarray  # [S]
    materials: Materials  # SoA, one per sphere

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@chex.dataclass(frozen=True)
class Lights:
    """Point lights (reference ``Light``/``PointLight``, light.h:8-17)."""

    position: jnp.ndarray   # [L, 3]
    color: jnp.ndarray      # [L, 3]
    intensity: jnp.ndarray  # [L]

    @property
    def count(self) -> int:
        return self.intensity.shape[0]


def make_materials(rows) -> Materials:
    """Build Materials from a list of (albedo, specular, rough, metal, use_spec)."""
    albedo, specular, rough, metal, use_spec = [], [], [], [], []
    for a, s, r, m, u in rows:
        albedo.append(a)
        specular.append(s)
        rough.append(r)
        metal.append(m)
        use_spec.append(u)
    return Materials(
        albedo=jnp.asarray(albedo, jnp.float32),
        specular=jnp.asarray(specular, jnp.float32),
        roughness=jnp.asarray(rough, jnp.float32),
        metalness=jnp.asarray(metal, jnp.float32),
        use_spec=jnp.asarray(use_spec, bool),
    )


def default_sphere_scene() -> Spheres:
    """The 5-sphere demo scene (raytrace_compute.glsl:299-364).

    Order matches the reference ``world[]`` array indices 0..4:
    blue, ground, green, red, yellow.
    """
    mats = make_materials([
        # Blue (material4, :327-331)
        ((0.2, 0.4, 1.0), (0.8, 0.8, 0.9), 0.01, 0.9, False),
        # Ground (material1, :306-310)
        ((0.2, 0.8, 0.8), (0.2, 0.4, 0.4), 0.01, 0.99, False),
        # Green (material3, :320-324)
        ((0.2, 0.9, 0.3), (0.2, 0.9, 0.9), 0.3, 0.95, True),
        # Red (material2, :313-317)
        ((0.8, 0.3, 0.3), (0.9, 0.7, 0.7), 0.1, 0.5, True),
        # Yellow (material5, :334-338)
        ((0.9, 0.8, 0.1), (0.3, 0.3, 0.1), 0.7, 0.3, False),
    ])
    center = jnp.asarray(
        [
            (1.8, 0.0, -2.0),     # blue   (:347-349)
            (0.0, -100.5, -1.0),  # ground (:342-344)
            (0.55, 0.0, -2.0),    # green  (:352-354)
            (-0.55, 0.0, -2.0),   # red    (:357-359)
            (-1.8, 0.0, -2.0),    # yellow (:362-364)
        ],
        jnp.float32,
    )
    radius = jnp.asarray([0.5, 100.0, 0.5, 0.5, 0.5], jnp.float32)
    return Spheres(center=center, radius=radius, materials=mats)


def sphere_scene_lights() -> Lights:
    """Two-light rig of the sphere scene (src/main.cpp:592-595)."""
    return Lights(
        position=jnp.asarray([(1.0, 2.0, 0.0), (-2.5, 2.0, 0.0)], jnp.float32),
        color=jnp.asarray([(1.0, 1.0, 1.0), (1.0, 1.0, 1.0)], jnp.float32),
        intensity=jnp.asarray([10.0, 3.0], jnp.float32),
    )


def model_scene_lights() -> Lights:
    """Six-light rig of the model scene (src/main.cpp:584-589)."""
    pos = [
        (1.0, 10.0, 10.0),
        (-5.0, 15.0, 10.0),
        (5.0, 15.0, 10.0),
        (-5.0, 5.0, 10.0),
        (5.0, 5.0, 10.0),
        (0.0, 21.0, 17.0),
    ]
    col = [
        (1.0, 1.0, 1.0),
        (1.0, 0.2, 0.2),
        (0.2, 1.0, 0.2),
        (0.2, 0.2, 1.0),
        (1.0, 1.0, 0.1),
        (1.0, 1.0, 1.0),
    ]
    inten = [50.0, 15.0, 15.0, 15.0, 15.0, 50.0]
    return Lights(
        position=jnp.asarray(pos, jnp.float32),
        color=jnp.asarray(col, jnp.float32),
        intensity=jnp.asarray(inten, jnp.float32),
    )


def random_sphere_scene(n: int, seed: int = 0) -> Spheres:
    """A procedural n-sphere scene for benchmarks and stress tests."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-4.0, 4.0, size=(n, 3)).astype(np.float32)
    center[:, 2] -= 4.0
    radius = rng.uniform(0.2, 0.6, size=(n,)).astype(np.float32)
    mats = Materials(
        albedo=jnp.asarray(rng.uniform(0.1, 0.9, size=(n, 3)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0.1, 0.9, size=(n, 3)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0.01, 0.9, size=(n,)), jnp.float32),
        metalness=jnp.asarray(rng.uniform(0.0, 1.0, size=(n,)), jnp.float32),
        use_spec=jnp.asarray(rng.uniform(size=(n,)) < 0.5),
    )
    return Spheres(center=jnp.asarray(center), radius=jnp.asarray(radius), materials=mats)
