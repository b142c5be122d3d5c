"""The vision-embedding tower for candidate-pair reranking, in PyTorch
(counterpart of the JAX package's ``models/embed.py``).

After the pHash prefilter finds candidate duplicate pairs, a learned
embedding (e.g. CLIP's vision tower) reranks them by cosine similarity
(``rerank.py``). The tower is a standard pre-norm ViT whose parameters load
from one ``.npz`` file, in float32 throughout on one device: the CUDA
device unless the caller passes ``device="cpu"``. It has no hand-written
kernel: its matmuls, softmax and layer norms are torch ops.

``.npz`` layout (shapes define the architecture; D = width, P = patch):
    patch_embed/kernel [P, P, 3, D]     patch_embed/bias [D]
    cls_token [D]                       pos_embed [N_patches + 1, D]
    blocks.{i}.ln1/scale|bias [D]       blocks.{i}.ln2/scale|bias [D]
    blocks.{i}.attn/qkv_kernel [D, 3D]  blocks.{i}.attn/qkv_bias [3D]
    blocks.{i}.attn/out_kernel [D, D]   blocks.{i}.attn/out_bias [D]
    blocks.{i}.mlp/fc1_kernel [D, H]    blocks.{i}.mlp/fc1_bias [H]
    blocks.{i}.mlp/fc2_kernel [H, D]    blocks.{i}.mlp/fc2_bias [D]
    ln_final/scale|bias [D]             proj [D, E]
    n_heads [] (int)                    image_size [] (int, e.g. 224)
    image_mean [3], image_std [3] (pixel normalization, 0..1 scale)
Optional keys (present in CLIP-converted checkpoints, see convert_clip.py):
    pre_ln/scale|bias [D]   layernorm applied after pos_embed, before blocks
    act [] (str)            MLP activation: "gelu_tanh" (default),
                            "gelu" (erf, torch nn.GELU), "quick_gelu" (CLIP)

Numerics that keep the tower equal to the JAX one: the 512 -> 224 resize
antialiases as ``jax.image.resize`` does when it shrinks; the patch
embedding is a matmul against the kernel reshaped to [P*P*3, D] in (h, w, c)
order (no ``conv2d``: cuDNN would run float32 convolutions in TF32).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


def load_params(path: str | Path) -> dict:
    """Load a ``.npz`` checkpoint into a plain dict of numpy arrays.

    The optional ``act`` entry is metadata, not a tensor; it stays a str.
    """
    with np.load(str(path)) as z:
        return {k: (str(z[k]) if k == "act" else np.asarray(z[k])) for k in z.files}


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "gelu": F.gelu,  # erf, torch nn.GELU
    "quick_gelu": _quick_gelu,  # original CLIP
}


def n_layers(params: dict) -> int:
    return 1 + max(
        int(k.split(".")[1].split("/")[0].split(".")[0])
        for k in params
        if k.startswith("blocks.")
    )


def resize(x: torch.Tensor, img: int) -> torch.Tensor:
    """[B, 3, H, W] float -> [B, 3, img, img]: bilinear, antialiased when it
    shrinks, as ``jax.image.resize(..., method="bilinear")``."""
    return F.interpolate(
        x, size=(img, img), mode="bilinear", align_corners=False, antialias=True
    )


class VisionEmbedder:
    """Embeds decoded 512x512 frames with a ViT checkpoint on one device.

    ``weights`` is a ``.npz`` path, or the numpy dict that ``load_params``
    returns (as ``make_synthetic_params`` and ``convert_clip`` make them).
    """

    def __init__(self, weights: "str | Path | dict", device=None):
        params = dict(weights) if isinstance(weights, dict) else load_params(weights)
        self.device = resolve_device(device)
        self.act = str(params.pop("act", "gelu_tanh"))
        self.act_fn = _ACTIVATIONS[self.act]
        self.layers = n_layers(params)
        self.heads = int(params.pop("n_heads"))
        self.img = int(params.pop("image_size"))
        self.params = {
            k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            for k, v in params.items()
        }
        kern = self.params["patch_embed/kernel"]  # HWIO [P, P, 3, D]
        self.patch = kern.shape[0]
        self.patch_kernel = kern.reshape(-1, kern.shape[-1])  # [(h, w, c), D]

    def _layer_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        p = self.params
        return F.layer_norm(x, x.shape[-1:], p[f"{name}/scale"], p[f"{name}/bias"], eps=1e-5)

    def _attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = self.params
        b, n, d = x.shape
        qkv = x @ p[f"blocks.{i}.attn/qkv_kernel"] + p[f"blocks.{i}.attn/qkv_bias"]
        hd = d // self.heads
        # [b, n, 3, heads, hd] -> three [b, heads, n, hd]
        q, k, v = qkv.reshape(b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-2, -1)) / math.sqrt(hd)
        out = torch.softmax(logits, dim=-1) @ v  # [b, heads, n, hd]
        out = out.transpose(1, 2).reshape(b, n, d)
        return out @ p[f"blocks.{i}.attn/out_kernel"] + p[f"blocks.{i}.attn/out_bias"]

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = self.params
        x = x + self._attention(self._layer_norm(x, f"blocks.{i}.ln1"), i)
        h = self._layer_norm(x, f"blocks.{i}.ln2")
        h = self.act_fn(h @ p[f"blocks.{i}.mlp/fc1_kernel"] + p[f"blocks.{i}.mlp/fc1_bias"])
        return x + (h @ p[f"blocks.{i}.mlp/fc2_kernel"] + p[f"blocks.{i}.mlp/fc2_bias"])

    def _patch_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, img, img] normalized pixels -> [B, N, D] patch tokens in
        row-major patch order: a VALID conv of stride P as one matmul."""
        b, c, h, w = x.shape
        P = self.patch
        gh, gw = h // P, w // P
        x = x[:, :, : gh * P, : gw * P].reshape(b, c, gh, P, gw, P)
        x = x.permute(0, 2, 4, 3, 5, 1).reshape(b, gh * gw, P * P * c)  # (h, w, c)
        return x @ self.patch_kernel + self.params["patch_embed/bias"]

    def forward(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """[B, 512, 512, 3] uint8 (any device) -> [B, E] L2-normalized
        float32 on the tower's device. The frames cross to the device as
        uint8 and are converted there."""
        p = self.params
        x = frames_u8.to(self.device, non_blocking=True)
        x = x.permute(0, 3, 1, 2).to(torch.float32) / 255.0
        x = resize(x, self.img)
        x = (x - p["image_mean"][:, None, None]) / p["image_std"][:, None, None]
        x = self._patch_tokens(x)
        cls = p["cls_token"].expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + p["pos_embed"]
        if "pre_ln/scale" in p:  # CLIP's embedding layernorm
            x = self._layer_norm(x, "pre_ln")
        for i in range(self.layers):
            x = self._block(x, i)
        x = self._layer_norm(x, "ln_final")
        emb = x[:, 0, :] @ p["proj"]  # class token -> embedding space
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """[B, 512, 512, 3] uint8 -> [B, E] L2-normalized float32."""
        with torch.inference_mode():
            return self.forward(torch.from_numpy(np.ascontiguousarray(frames_u8))).cpu().numpy()

    def embed_video(self, frames_u8: np.ndarray) -> np.ndarray:
        """Video embedding = normalized mean of frame embeddings."""
        e = self.embed_frames(frames_u8).mean(axis=0)
        n = np.linalg.norm(e)
        return e / n if n > 0 else e


def embedder_from_params(params: dict, device=None) -> VisionEmbedder:
    """The port's tower from the numpy dict that the JAX package's
    ``load_params`` reads (or that ``make_synthetic_params`` or
    ``convert_clip.convert_vision_model`` returns)."""
    return VisionEmbedder(params, device)


def make_synthetic_params(
    rng: np.random.Generator,
    width: int = 64,
    layers: int = 2,
    heads: int = 4,
    patch: int = 32,
    image_size: int = 224,
    embed_dim: int = 32,
    pixel_identity: bool = False,
) -> dict:
    """Random (or pixel-passthrough) checkpoint for tests/benchmarks.

    pixel_identity=True zeroes the transformer so the embedding is a pure
    function of mean patch pixels — visually similar videos then embed
    close together, letting tests assert rerank *semantics* without real
    trained weights.
    """
    n_patches = (image_size // patch) ** 2
    hidden = width * 4

    def r(*shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    p = {
        "patch_embed/kernel": r(patch, patch, 3, width),
        "patch_embed/bias": np.zeros(width, np.float32),
        "cls_token": r(width),
        "pos_embed": r(n_patches + 1, width),
        "ln_final/scale": np.ones(width, np.float32),
        "ln_final/bias": np.zeros(width, np.float32),
        "proj": r(width, embed_dim),
        "n_heads": np.asarray(heads),
        "image_size": np.asarray(image_size),
        "image_mean": np.asarray([0.48, 0.46, 0.41], np.float32),
        "image_std": np.asarray([0.27, 0.26, 0.28], np.float32),
    }
    for i in range(layers):
        p[f"blocks.{i}.ln1/scale"] = np.ones(width, np.float32)
        p[f"blocks.{i}.ln1/bias"] = np.zeros(width, np.float32)
        p[f"blocks.{i}.ln2/scale"] = np.ones(width, np.float32)
        p[f"blocks.{i}.ln2/bias"] = np.zeros(width, np.float32)
        if pixel_identity:
            # mean-pool attention: q = k = 0 (uniform softmax), v = out = I,
            # so every token (incl. cls) accumulates the mean patch content
            qkv = np.zeros((width, 3 * width), np.float32)
            qkv[:, 2 * width :] = np.eye(width, dtype=np.float32)
            p[f"blocks.{i}.attn/qkv_kernel"] = qkv
            p[f"blocks.{i}.attn/out_kernel"] = np.eye(width, dtype=np.float32)
            p[f"blocks.{i}.mlp/fc1_kernel"] = np.zeros((width, hidden), np.float32)
            p[f"blocks.{i}.mlp/fc2_kernel"] = np.zeros((hidden, width), np.float32)
        else:
            p[f"blocks.{i}.attn/qkv_kernel"] = r(width, 3 * width)
            p[f"blocks.{i}.attn/out_kernel"] = r(width, width)
            p[f"blocks.{i}.mlp/fc1_kernel"] = r(width, hidden)
            p[f"blocks.{i}.mlp/fc2_kernel"] = r(hidden, width)
        p[f"blocks.{i}.attn/qkv_bias"] = np.zeros(3 * width, np.float32)
        p[f"blocks.{i}.attn/out_bias"] = np.zeros(width, np.float32)
        p[f"blocks.{i}.mlp/fc1_bias"] = np.zeros(hidden, np.float32)
        p[f"blocks.{i}.mlp/fc2_bias"] = np.zeros(width, np.float32)
    if pixel_identity:
        # patch embed becomes a mean-pixel projector with stable scale
        k = np.zeros((patch, patch, 3, width), np.float32)
        for c in range(3):
            k[:, :, c, c::3] = 1.0 / (patch * patch)
        p["patch_embed/kernel"] = k
    return p
