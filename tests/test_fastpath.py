"""Library-default fast path (models/fastpath): the public API the
headline bench measures.  On the CPU the "bvh" candidate search stands in
for the GPU kernel; the plan's output must match the dense method
bit-for-bit on tie-free scenes, at spp=1 and with the spp-batched
wavefront."""

import jax
import numpy as np
import pytest

from srt_tpu.config import CameraConfig, RenderConfig
from srt_tpu.models import mesh as mesh_mod
from srt_tpu.models.fastpath import make_render_plan
from srt_tpu.scene import model_scene_lights
from srt_tpu.utils.flatten import flatten_models
from srt_tpu.utils.procgen import uv_sphere


@pytest.fixture(scope="module")
def setup():
    scene = mesh_mod.upload(
        flatten_models([uv_sphere(12, 18, radius=2.0)], pad_to=128))
    lights = model_scene_lights()
    cam = CameraConfig(width=32, height=32, origin=(0.0, 1.0, 5.0),
                       look_at=(0.0, 0.0, 0.0))
    return scene, lights, cam


@pytest.mark.parametrize("spp", [1, 4])
def test_plan_bvh_matches_dense(setup, spp):
    scene, lights, cam = setup
    cfg = RenderConfig(max_depth=3, rr_bounces=0, spp=spp)
    imgs = {}
    for method in ("bvh", "dense"):
        plan = make_render_plan(scene, lights, cam, cfg, method=method)
        img, stats, overflow = plan.render(jax.random.key(2))
        assert int(overflow) == 0
        assert np.isfinite(np.asarray(img)).all()
        assert int(np.asarray(stats).sum()) > 0
        imgs[method] = np.asarray(img)
    # Bit-equality holds except at exact-t ties on shared triangle edges
    # (measure-zero; the documented candidate-vs-dense divergence).  At
    # 4096 rays a couple of tie pixels appear; bound them instead.
    diff = np.abs(imgs["bvh"] - imgs["dense"]).max(axis=-1)
    assert (diff > 1e-6).mean() < 0.005, \
        f"{(diff > 1e-6).sum()} differing pixels"


def test_spp_mean_matches_statistics(setup):
    """The K-sample batched image must equal the mean of K independently
    keyed 1-spp frames in expectation; check the two agree to well under
    the per-pixel noise level on the mean over the image."""
    scene, lights, cam = setup
    plan4 = make_render_plan(scene, lights, cam,
                             RenderConfig(max_depth=2, rr_bounces=0, spp=4),
                             method="dense")
    img4, _, _ = plan4.render(jax.random.key(3))
    plan1 = make_render_plan(scene, lights, cam,
                             RenderConfig(max_depth=2, rr_bounces=0),
                             method="dense")
    acc = None
    for i in range(4):
        im, _, _ = plan1.render(jax.random.key(100 + i))
        acc = np.asarray(im) if acc is None else acc + np.asarray(im)
    assert abs(float(np.asarray(img4).mean()) - float(acc.mean() / 4)) < 0.02
