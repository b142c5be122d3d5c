"""The port's vision tower (``models/embed.py``) against the JAX package's
on the same numpy checkpoint dict, on the CPU: the resize, the tower for
each activation with and without CLIP's pre-layernorm, the video
embedding, the checkpoint reader and the synthetic checkpoints. A
``cuda``-marked test holds the tower on the card against the CPU."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrus_video_deduplicator_tpu.models import embed as jax_embed
from hydrus_video_deduplicator_tpu_torch.models import embed

#: max abs error of unit-norm embeddings, port against JAX (both float32)
EMBED_TOL = 1e-5
#: max abs error of the resized pixels (0..1 scale)
RESIZE_TOL = 1e-6
#: max abs error of unit-norm embeddings, the card against the CPU
CARD_TOL = 1e-4


def _params(act: str, pre_ln: bool, seed: int = 0, **shape) -> dict:
    """Random weights at make_synthetic_params(width=64, layers=2, heads=4)
    (or ``shape``), with every kernel and the projection redrawn with
    variance 1 / fan-in and random layer norms and biases, so that the
    frame's content and every parameter move the embedding."""
    rng = np.random.default_rng(seed)
    p = embed.make_synthetic_params(rng, **{"width": 64, "layers": 2, "heads": 4, **shape})
    for k in list(p):
        if k.endswith("kernel") or k == "proj":
            fan_in = int(np.prod(p[k].shape[:-1]))
            p[k] = (rng.standard_normal(p[k].shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k.endswith(("/bias", "/scale")):
            base = 1.0 if k.endswith("/scale") else 0.0
            p[k] = (base + 0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    if pre_ln:
        width = p["cls_token"].shape[0]
        p["pre_ln/scale"] = (1.0 + 0.1 * rng.standard_normal(width)).astype(np.float32)
        p["pre_ln/bias"] = (0.1 * rng.standard_normal(width)).astype(np.float32)
    p["act"] = np.asarray(act)
    return p


def _jax_embed(params: dict, frames: np.ndarray) -> np.ndarray:
    """The JAX package's jitted tower on the same dict, in float32."""
    p = {k: jnp.asarray(v) for k, v in params.items() if k != "act"}
    act = str(params.get("act", "gelu_tanh"))
    with jax.default_matmul_precision("float32"):
        out = jax_embed._embed(
            jnp.asarray(frames), p, jax_embed.n_layers(p), int(p["n_heads"]),
            int(p["image_size"]), act,
        )
    return np.asarray(out)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (3, 512, 512, 3), dtype=np.uint8)


@pytest.mark.parametrize("img", [224, 64])
def test_resize_matches_jax_image_resize(img):
    x = np.random.default_rng(img).random((2, 512, 512, 3), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, img, img, 3), method="bilinear"))
    got = embed.resize(torch.from_numpy(x).permute(0, 3, 1, 2), img).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("pre_ln", [False, True], ids=["no_pre_ln", "pre_ln"])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "quick_gelu"])
def test_tower_matches_the_jax_tower(frames, act, pre_ln):
    params = _params(act, pre_ln)
    tower = embed.embedder_from_params(params, "cpu")
    assert (tower.act, tower.layers, tower.heads, tower.img) == (act, 2, 4, 224)
    got = tower.embed_frames(frames)
    want = _jax_embed(params, frames)
    assert got.shape == want.shape == (3, 32) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=EMBED_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    assert float(got[0] @ got[1]) < 0.99  # the frames' content moves the embedding


def test_embed_video_matches_the_jax_embedder(frames, tmp_path):
    path = tmp_path / "vit.npz"
    np.savez(path, **_params("quick_gelu", True, seed=3))
    got = embed.VisionEmbedder(path, device="cpu").embed_video(frames)
    want = jax_embed.VisionEmbedder(path).embed_video(frames)
    assert got.shape == want.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=0, atol=EMBED_TOL)
    assert abs(float(np.linalg.norm(got)) - 1.0) < EMBED_TOL


def test_load_params_reads_a_checkpoint_the_jax_package_wrote(tmp_path):
    """The JAX package's synthetic checkpoint with CLIP's optional keys, as
    its converter saves one (np.savez): the port reads the same arrays and
    the same architecture."""
    params = _params("gelu", True, seed=5)
    path = tmp_path / "clip.npz"
    np.savez(path, **params)
    ours, theirs = embed.load_params(path), jax_embed.load_params(path)
    assert set(ours) == set(theirs) == set(params)
    assert ours["act"] == theirs["act"] == "gelu"
    for k in params:
        if k != "act":
            assert ours[k].dtype == params[k].dtype, k  # jax holds int64 scalars as int32
            np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    port_tower = embed.VisionEmbedder(path, device="cpu")
    jax_tower = jax_embed.VisionEmbedder(path)
    assert (port_tower.act, port_tower.layers, port_tower.heads, port_tower.img) == (
        jax_tower.act, jax_tower.layers, jax_tower.heads, jax_tower.img
    )


@pytest.mark.parametrize("pixel_identity", [False, True])
def test_synthetic_params_equal_the_jax_package_s(pixel_identity):
    kwargs = {"width": 48, "layers": 3, "heads": 4, "patch": 16, "image_size": 64,
              "embed_dim": 8, "pixel_identity": pixel_identity}
    ours = embed.make_synthetic_params(np.random.default_rng(11), **kwargs)
    theirs = jax_embed.make_synthetic_params(np.random.default_rng(11), **kwargs)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_the_tower_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed.embedder_from_params(_params("gelu", False))
    assert embed.embedder_from_params(_params("gelu", False), "cpu").device.type == "cpu"


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the tower on the card with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tower_on_the_card_matches_the_cpu_at_vit_b32(cuda_device):
    """CLIP ViT-B/32's shape (width 768, 12 layers, 12 heads, patch 32, 224,
    projection 512, quick_gelu, pre_ln), random weights."""
    params = _params(
        "quick_gelu", True, seed=1, width=768, layers=12, heads=12, patch=32,
        image_size=224, embed_dim=512,
    )
    frames = np.random.default_rng(2).integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)
    card = embed.embedder_from_params(params, cuda_device)
    assert all(t.is_cuda for t in card.params.values())
    got = card.embed_frames(frames)
    want = embed.embedder_from_params(params, "cpu").embed_frames(frames)
    np.testing.assert_allclose(got, want, rtol=0, atol=CARD_TOL)
