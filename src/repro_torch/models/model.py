"""Model assembly, dense arch (port of `repro.models.model`).

The parameter tree keeps the JAX layout: {"embed_block": {...},
"groups": [(layer_params_stacked_on_[L, ...],)]}. The reference scans the
stacked layers with `lax.scan`; here a Python loop walks the layer axis
(each slice is a view). Caches keep the reference's layout too:
[(({"k","v": [L, B, T, K, Dh], "kv_pos": [L, B, T]}),)].

Public API (functions over a params tree):
  model.init(generator)                          -> params
  model.prefill(params, batch, cache_len, true_len)
                                                 -> (logits [B,S,V], caches)
  model.decode_step(params, caches, token, pos)  -> (logits [B,V], caches)
Decode updates `caches` in place and returns the same object.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import (dtype_of, embed_tokens, init_attention, init_embed,
                     init_ffn, lm_logits)
from .config import ModelConfig
from .layers import KIND_DECODE, KIND_PREFILL, init_kv_cache
from ..device import resolve_device


def layer_groups(cfg: ModelConfig):
    """-> list of (pattern tuple, count). Only the dense arch is ported."""
    if cfg.arch_type == "dense":
        return [(("attn",), cfg.num_layers)]
    raise NotImplementedError(
        f"arch_type {cfg.arch_type!r} is not ported to PyTorch yet")


def _slice(tree, i):
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@dataclass
class Model:
    cfg: ModelConfig
    device: torch.device = torch.device("cpu")

    # ------------------------------ init ---------------------------------
    def init(self, gen: torch.Generator):
        """Random params with the reference's shapes and scales (normal x
        1/sqrt(fan_in); embedding scale 1.0; norms ones; biases zeros),
        drawn from `gen` on its device. The numbers are torch's, not
        jax.random's: parity tests bridge the reference's params
        instead (`repro_torch.bridge`)."""
        cfg = self.cfg
        dtype = dtype_of(cfg)
        params = {"embed_block": init_embed(gen, cfg, dtype), "groups": []}
        for pat, count in layer_groups(cfg):
            lead = (count,)
            layer = {
                "ln1": torch.ones((count, cfg.d_model), dtype=dtype,
                                  device=gen.device),
                "attn": init_attention(gen, cfg, dtype, lead),
                "ln2": torch.ones((count, cfg.d_model), dtype=dtype,
                                  device=gen.device),
                "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, dtype, lead),
            }
            params["groups"].append((layer,))
        return params

    # ----------------------------- prefill -------------------------------
    def prefill(self, params, batch, cache_len=None, true_len=None):
        """true_len (int, optional): number of real prompt tokens when
        `tokens` is padded to a bucket length — padded positions get
        kv_pos = -1 so they can never be attended."""
        cfg = self.cfg
        ctx = {}
        if cache_len is not None:
            ctx["cache_len"] = cache_len
        if true_len is not None:
            ctx["true_len"] = true_len
        x = embed_tokens(params["embed_block"], batch["tokens"])
        caches = []
        for (pat, count), gp in zip(layer_groups(cfg), params["groups"]):
            per_layer = []
            for i in range(count):
                cs = []
                for j, kind in enumerate(pat):
                    x, c = KIND_PREFILL[kind](_slice(gp[j], i), x, cfg, ctx)
                    cs.append(c)
                per_layer.append(cs)
            caches.append(tuple(
                {name: torch.stack([pl[j][name] for pl in per_layer])
                 for name in per_layer[0][j]}
                for j in range(len(pat))))
        return lm_logits(params["embed_block"], x, cfg), caches

    # ------------------------------ decode -------------------------------
    def decode_step(self, params, caches, token, pos, batch_ctx=None):
        """token [B] int, pos [B] or scalar int -> (logits [B,V], caches);
        the caches are written in place."""
        cfg = self.cfg
        ctx = dict(batch_ctx or {})
        ctx["pos"] = pos
        x = embed_tokens(params["embed_block"], token[:, None])
        for (pat, count), gp, gc in zip(layer_groups(cfg), params["groups"],
                                        caches):
            for i in range(count):
                for j, kind in enumerate(pat):
                    x, _ = KIND_DECODE[kind](_slice(gp[j], i), x,
                                             _slice(gc[j], i), cfg, ctx)
        return lm_logits(params["embed_block"], x, cfg)[:, 0], caches

    @property
    def prefill_padding_safe(self) -> bool:
        """True iff prefill tolerates a zero-padded prompt tail under
        `true_len` masking (attention kinds mask it through kv_pos)."""
        return all(kind not in ("rec", "ssm")
                   for pat, _ in layer_groups(self.cfg) for kind in pat)

    @property
    def supports_span_decode(self) -> bool:
        """True iff every decode layer kind is position-addressed, so a
        discarded speculative forward rewrites idempotently."""
        return all(kind in ("attn", "moe")
                   for pat, _ in layer_groups(self.cfg) for kind in pat)

    # ------------------------- cache construction ------------------------
    def init_decode_caches(self, batch_size: int, cache_len: int):
        """Zero caches shaped for decode (the serving engine's slot pool)."""
        cfg = self.cfg
        L = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
            else cache_len
        return [tuple(init_kv_cache(cfg, batch_size, L, dtype_of(cfg),
                                    self.device, lead=(count,))
                      for _ in pat)
                for pat, count in layer_groups(cfg)]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, resolve_device(device))
