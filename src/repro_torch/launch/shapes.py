"""Assigned input shapes and per-(arch, shape) abstract inputs (port of
`repro.launch.shapes`).

``input_specs(model, shape)`` returns the inputs of the step the shape
exercises as meta tensors (shapes and dtypes, no storage), where the
reference returns `jax.ShapeDtypeStruct`s:
  * train_4k     -> train_step(params, opt_state, batch)
  * prefill_32k  -> prefill(params, batch)
  * decode_*     -> decode_step(params, caches, token, pos) and the
    grammar mask's inputs

Applicability carve-outs (as the reference's):
  * long_500k needs bounded state: ssm/hybrid run natively; dense/moe/vlm
    run the sliding-window variant (window 8192); whisper is skipped.
  * whisper decode shapes drive the *decoder* step; the conv/mel
    front end is stubbed by precomputed frame embeddings.
"""
from __future__ import annotations

from dataclasses import replace

import torch

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, mode="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, mode="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, mode="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, mode="decode"),
}

SLIDING_WINDOW_FOR_LONG = 8192

# sized for the Python grammar scale the paper reports (|Γ|=94 terminals,
# a few thousand DFA states x (|Γ|+1) rows)
MASK_STORE_ROWS = 16384
MAX_ACCEPT = 48

_META = torch.device("meta")


def applicable(cfg, shape: str) -> tuple[bool, str]:
    if shape == "long_500k":
        if cfg.arch_type == "audio":
            return False, ("whisper-base is full-attention enc-dec; no "
                           "faithful sub-quadratic variant (DESIGN.md §4)")
    return True, ""


def variant_for_shape(cfg, shape: str):
    """Config actually run for this shape."""
    if shape == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        return replace(cfg, sliding_window=SLIDING_WINDOW_FOR_LONG)
    return cfg


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def batch_specs(cfg, seq_len: int, batch: int, with_labels: bool):
    b = {"tokens": _sds((batch, seq_len), torch.int32)}
    if with_labels:
        b["labels"] = _sds((batch, seq_len), torch.int32)
        b["loss_mask"] = _sds((batch, seq_len), torch.float32)
    if cfg.arch_type == "vlm":
        b["image_embeds"] = _sds((batch, cfg.num_image_tokens, cfg.d_model),
                                 torch.bfloat16)
    if cfg.arch_type == "audio":
        b["frames"] = _sds((batch, cfg.audio_frames, cfg.d_model),
                           torch.bfloat16)
    return b


def mask_words(cfg) -> int:
    """Packed uint32 words of the mask store, rounded up to 16 so the
    "model" axis divides them."""
    words = (cfg.vocab_size + 31) // 32
    return ((words + 15) // 16) * 16


def input_specs(model, shape: str):
    """-> (mode, specs dict) for a `Model` on the meta device. specs keys
    depend on mode:
    train:   params, opt_state, batch
    prefill: params, batch
    decode:  params, caches, token, pos, mask_store, mask_rows, mask_cd,
             eos_allowed (the paper's grammar mask: packed DFA mask-store
             rows, uint32 bit-words over the vocab, and per-request row
             ids from the host's incremental parser)
    The caches are built on the meta device whatever the model's."""
    cfg = model.cfg
    info = SHAPES[shape]
    S, B, mode = info["seq_len"], info["global_batch"], info["mode"]
    params = model.abstract_params()
    if mode == "train":
        from ..training.optimizer import init_opt_state
        return mode, {
            "params": params,
            "opt_state": init_opt_state(params),
            "batch": batch_specs(cfg, S, B, with_labels=True),
        }
    if mode == "prefill":
        return mode, {
            "params": params,
            "batch": batch_specs(cfg, S, B, with_labels=False),
        }
    if mode == "decode":
        from ..models.model import Model
        words = mask_words(cfg)
        return mode, {
            "params": params,
            "caches": Model(cfg, device="meta").init_decode_caches(B, S),
            "token": _sds((B,), torch.int32),
            "pos": _sds((B,), torch.int32),
            "mask_store": _sds((MASK_STORE_ROWS, words), torch.uint32),
            "mask_rows": _sds((B, MAX_ACCEPT), torch.int32),
            "mask_cd": _sds((B, words), torch.uint32),
            "eos_allowed": _sds((B,), torch.bool),
        }
    raise ValueError(mode)
