"""Convert a Hugging Face CLIP vision checkpoint to the rerank ``.npz`` layout.

The ``--rerank clip`` pipeline (rerank.py) embeds candidate pairs with the
jitted ViT in embed.py, which loads any checkpoint in the documented ``.npz``
layout. Real CLIP weights cannot ship with the framework; this converter
makes them a one-command user step:

    python -m hydrus_video_deduplicator_tpu_torch.models.convert_clip \
        openai/clip-vit-base-patch32 clip_b32.npz

Any local directory or hub id loadable by
``transformers.CLIPVisionModelWithProjection`` works (full CLIPModel
checkpoints included — the text tower is simply ignored). Numerical parity
of the converted tower against the torch implementation is asserted in
tests/unit_tests/test_convert_clip.py with randomly initialized models of
both CLIP activation variants.

Mapping notes (HF ``CLIPVisionTransformer`` -> embed.py layout):
  - torch Linear weights are [out, in] -> transposed to [in, out]
  - q/k/v projections concatenate to one [D, 3D] qkv kernel
  - CLIP's patch conv has no bias -> zeros
  - ``pre_layrnorm`` (sic, HF attribute) -> ``pre_ln``
  - ``hidden_act`` ("quick_gelu" for OpenAI CLIP, "gelu" for most others)
    -> the ``act`` metadata entry
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# OpenAI CLIP preprocessing statistics (0..1 pixel scale), used when the
# checkpoint directory carries no image-processor config.
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_ACT_MAP = {
    "quick_gelu": "quick_gelu",
    "gelu": "gelu",
    "gelu_new": "gelu_tanh",
    "gelu_pytorch_tanh": "gelu_tanh",
}


def convert_vision_model(model, image_mean=None, image_std=None) -> dict:
    """Convert an instantiated ``CLIPVisionModelWithProjection`` to the
    embed.py ``.npz`` parameter dict (plain numpy arrays)."""
    cfg = model.config
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    vm = "vision_model."

    def t(name):  # torch Linear [out, in] -> [in, out]
        return np.ascontiguousarray(sd[name].T)

    width = cfg.hidden_size
    p = {
        # torch Conv2d [D, 3, P, P] -> HWIO [P, P, 3, D]
        "patch_embed/kernel": np.ascontiguousarray(
            sd[vm + "embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
        ),
        "patch_embed/bias": np.zeros(width, np.float32),
        "cls_token": sd[vm + "embeddings.class_embedding"],
        "pos_embed": sd[vm + "embeddings.position_embedding.weight"],
        "ln_final/scale": sd[vm + "post_layernorm.weight"],
        "ln_final/bias": sd[vm + "post_layernorm.bias"],
        "proj": t("visual_projection.weight"),
        "n_heads": np.asarray(cfg.num_attention_heads),
        "image_size": np.asarray(cfg.image_size),
        "image_mean": np.asarray(image_mean or OPENAI_CLIP_MEAN, np.float32),
        "image_std": np.asarray(image_std or OPENAI_CLIP_STD, np.float32),
        "act": np.asarray(_ACT_MAP.get(cfg.hidden_act, "gelu_tanh")),
    }
    # HF attribute name changed across versions; accept either spelling
    for pre in ("pre_layrnorm", "pre_layernorm"):
        if vm + pre + ".weight" in sd:
            p["pre_ln/scale"] = sd[vm + pre + ".weight"]
            p["pre_ln/bias"] = sd[vm + pre + ".bias"]
            break
    for i in range(cfg.num_hidden_layers):
        lyr = f"{vm}encoder.layers.{i}."
        p[f"blocks.{i}.ln1/scale"] = sd[lyr + "layer_norm1.weight"]
        p[f"blocks.{i}.ln1/bias"] = sd[lyr + "layer_norm1.bias"]
        p[f"blocks.{i}.ln2/scale"] = sd[lyr + "layer_norm2.weight"]
        p[f"blocks.{i}.ln2/bias"] = sd[lyr + "layer_norm2.bias"]
        p[f"blocks.{i}.attn/qkv_kernel"] = np.concatenate(
            [t(lyr + f"self_attn.{w}_proj.weight") for w in ("q", "k", "v")], axis=1
        )
        p[f"blocks.{i}.attn/qkv_bias"] = np.concatenate(
            [sd[lyr + f"self_attn.{w}_proj.bias"] for w in ("q", "k", "v")]
        )
        p[f"blocks.{i}.attn/out_kernel"] = t(lyr + "self_attn.out_proj.weight")
        p[f"blocks.{i}.attn/out_bias"] = sd[lyr + "self_attn.out_proj.bias"]
        p[f"blocks.{i}.mlp/fc1_kernel"] = t(lyr + "mlp.fc1.weight")
        p[f"blocks.{i}.mlp/fc1_bias"] = sd[lyr + "mlp.fc1.bias"]
        p[f"blocks.{i}.mlp/fc2_kernel"] = t(lyr + "mlp.fc2.weight")
        p[f"blocks.{i}.mlp/fc2_bias"] = sd[lyr + "mlp.fc2.bias"]
    return p


def convert_checkpoint(name_or_path: str, out_path: str | Path) -> Path:
    """Load an HF CLIP checkpoint (hub id or local dir) and write the
    rerank ``.npz``. Returns the written path."""
    from transformers import CLIPVisionModelWithProjection

    model = CLIPVisionModelWithProjection.from_pretrained(name_or_path)
    mean = std = None
    try:  # preprocessing stats, when the checkpoint dir carries them
        from transformers import CLIPImageProcessor

        proc = CLIPImageProcessor.from_pretrained(name_or_path)
        mean, std = proc.image_mean, proc.image_std
    except Exception:
        pass
    params = convert_vision_model(model, mean, std)
    out_path = Path(out_path)
    np.savez(out_path, **params)
    return out_path


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert an HF CLIP vision checkpoint to the rerank .npz layout"
    )
    ap.add_argument("checkpoint", help="HF hub id or local checkpoint directory")
    ap.add_argument("output", help="output .npz path")
    args = ap.parse_args(argv)
    out = convert_checkpoint(args.checkpoint, args.output)
    print(f"wrote {out} — use with --rerank clip --rerank-weights {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
