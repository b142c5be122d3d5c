"""The port's copy of the CLIP converter (``models/convert_clip.py``):
Hugging Face's torch ``CLIPVisionModelWithProjection`` with random weights,
converted, gives the port's tower the same normalized image embeddings as
the torch original on the same pixels, and the same parameter dict as the
JAX package's converter. Skips without ``transformers``, as the JAX
package's test does."""

from __future__ import annotations

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from hydrus_video_deduplicator_tpu.models import convert_clip as jax_convert  # noqa: E402
from hydrus_video_deduplicator_tpu_torch.models import embed  # noqa: E402
from hydrus_video_deduplicator_tpu_torch.models.convert_clip import (  # noqa: E402
    convert_vision_model,
)

#: max abs error of unit-norm embeddings, the port's tower against HF's
#: (both torch float32 on the CPU)
TOL = 1e-5


def _small_clip(hidden_act: str, seed: int = 0):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    cfg = CLIPVisionConfig(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        image_size=64,
        patch_size=16,
        projection_dim=32,
        hidden_act=hidden_act,
    )
    return CLIPVisionModelWithProjection(cfg).eval()


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_converted_tower_matches_torch(hidden_act):
    model = _small_clip(hidden_act)
    params = convert_vision_model(model)
    reference = jax_convert.convert_vision_model(model)
    assert set(params) == set(reference)
    for k in params:
        np.testing.assert_array_equal(params[k], reference[k], err_msg=k)
    assert str(params["act"]) == hidden_act and "pre_ln/scale" in params

    tower = embed.embedder_from_params(params, "cpu")
    frames = np.random.default_rng(7).integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)
    ours = tower.embed_frames(frames)

    # the tower's own preprocessing, handed to HF as NCHW pixel values
    x = torch.from_numpy(frames).permute(0, 3, 1, 2).float() / 255.0
    x = embed.resize(x, tower.img)
    x = (x - tower.params["image_mean"][:, None, None]) / tower.params["image_std"][:, None, None]
    with torch.no_grad():
        theirs = model(pixel_values=x).image_embeds.numpy()
    theirs = theirs / np.linalg.norm(theirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=TOL)
