"""Model assembly (port of `repro.models.model`) for the dense, moe, ssm,
hybrid, vlm and audio (Whisper) archs.

Layers of one structure are stacked into groups, each a fixed pattern of
kinds (hybrid: ("rec", "rec", "attn") x n plus a remainder group; vlm:
("attn" x (cross_attn_every - 1), "cross") x n plus an attention-only
remainder group; moe: a leading dense group when `first_dense_layers`).
The parameter tree keeps the JAX layout: {"embed_block": {...},
"groups": [(kind_params_stacked_on_[count, ...], ...)]}, plus "encoder":
({enc params stacked on [encoder_layers, ...]},) for audio. The
reference scans each group with `lax.scan`; here a Python loop walks the
layer axis (each slice is a view). Caches keep the reference's layout
too, one tree per pattern position stacked on [count, ...]: attention
{"k","v": [L, B, T, K, Dh], "kv_pos": [L, B, T]}, rec {"h": [L, B, R],
"conv"}, ssm {"h": [L, B, Hs, N, P], "conv"}, cross {"k","v": [L, B,
num_image_tokens, K, Dh]}, dec {"self": an attention cache, "cross":
{"k","v": [L, B, frames, K, Dh]}}.

Side inputs. Audio: the batch carries `frames` [B, audio_frames,
d_model] (the conv front end's output; the reference stubs that front
end too). The encoder runs them through its `enc` layers once per call
(`_encode_frames`), and every `dec` layer attends to the result. vlm:
the batch carries `image_embeds` [B, num_image_tokens, d_model] (the
vision tower's output, stubbed in the reference too), which every
`cross` layer attends to. A side input keeps its dtype, as in the
reference: fp32 frames under bf16 weights run the whole encoder in fp32,
and fp32 frames or image embeddings give fp32 cross K/V (`prefill`
returns them so, while `init_decode_caches` makes caches in the model's
dtype, as the reference's does); bf16 queries attend to them on the
fp32 kernel route (`layers._cross_attention`).

Public API (functions over a params tree):
  model.init(generator)                          -> params
  model.train_logits(params, batch)              -> (logits [B,S,V], aux)
  model.loss(params, batch)                      -> (scalar, metrics)
  model.prefill(params, batch, cache_len, true_len)
                                                 -> (logits [B,S,V], caches)
  model.decode_step(params, caches, token, pos)  -> (logits [B,V], caches)
  model.decode_span(params, caches, tokens, pos, feed_mask, batch_ctx)
                                                 -> (logits [B,S,V], caches)
Decode updates `caches` in place and returns the same object. Given one
rank's serving params (`bridge.shard_params`) inside the sharded engine's
`use_sharding` context, V is the rank's vocab block V_s: the lookup
combines across ranks (`common.embed_tokens`), the trunk is whole. Training
differentiates with torch autograd; `cfg.remat` checkpoints each layer
(`torch.utils.checkpoint`, non-reentrant) where the reference wraps its
scan body in `jax.checkpoint`. Paged KV
pools (`init_paged_caches`) keep the reference's leaf layout
{"k","v": [count, P, ps, K, Dh]}; a page table in `batch_ctx` routes the
attention layers to them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from .common import (cross_entropy_loss, dtype_of, embed_tokens, init_embed,
                     lm_logits)
from .config import ModelConfig
from .layers import (KIND_DECODE, KIND_INIT, KIND_PREFILL, KIND_TRAIN,
                     init_kv_cache)
from .rglru import init_rglru_cache
from .ssm import init_ssm_cache
from ..device import resolve_device

LB_COEF = 0.01
Z_COEF = 0.001


def layer_groups(cfg: ModelConfig):
    """-> list of (pattern tuple, count), the decoder-side stack."""
    L = cfg.num_layers
    at = cfg.arch_type
    if at == "dense":
        return [(("attn",), L)]
    if at == "moe":
        fd = cfg.first_dense_layers
        return ([(("attn",), fd)] if fd else []) + [(("moe",), L - fd)]
    if at == "ssm":
        return [(("ssm",), L)]
    if at == "hybrid":
        pat = tuple(cfg.block_pattern)
        n, rem = divmod(L, len(pat))
        return ([(pat, n)] if n else []) + ([(pat[:rem], 1)] if rem else [])
    if at == "vlm":
        e = cfg.cross_attn_every
        n, rem = divmod(L, e)
        return ([(("attn",) * (e - 1) + ("cross",), n)] if n else []) + \
            ([(("attn",) * rem, 1)] if rem else [])
    if at == "audio":
        return [(("dec",), L)]
    raise ValueError(at)


def _slice(tree, i):
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _stack(trees):
    """Per-layer cache trees (nested dicts of tensors) -> one tree with
    each leaf stacked on a leading layer axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


class _MetaDraw:
    """The generator `abstract_params` hands to the init functions: its
    device is meta, so `dense_init` allocates and draws nothing
    (`torch.Generator` has no meta device)."""
    device = torch.device("meta")


@dataclass
class Model:
    """`device` is resolved like every entry point's: "cuda" unless the
    caller asks for the CPU, raising when there is no card. "meta" is the
    abstract path (the dry run's): params and caches with shapes and
    dtypes and no storage, never a default."""
    cfg: ModelConfig
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device, abstract=True)

    # ------------------------------ init ---------------------------------
    def init(self, gen: torch.Generator):
        """Random params with the reference's shapes and scales (normal x
        1/sqrt(fan_in); embedding scale 1.0; conv kernels 0.5; norms
        ones; biases zeros; the MoE router and the recurrent gates' fp32
        leaves as the reference keeps them), drawn from `gen` on its
        device. The numbers are torch's, not jax.random's: parity tests
        bridge the reference's params instead (`repro_torch.bridge`)."""
        cfg = self.cfg
        dtype = dtype_of(cfg)
        params = {"embed_block": init_embed(gen, cfg, dtype), "groups": []}
        for pat, count in layer_groups(cfg):
            params["groups"].append(tuple(
                KIND_INIT[kind](gen, cfg, dtype, (count,)) for kind in pat))
        if cfg.arch_type == "audio":
            params["encoder"] = (KIND_INIT["enc"](
                gen, cfg, dtype, (cfg.encoder_layers,)),)
        return params

    def abstract_params(self):
        """The param tree of `init` (same tree, shapes and dtypes) as
        meta tensors: no storage, no draw (the counterpart of the
        reference's `jax.eval_shape(self.init, rng)`)."""
        return self.init(_MetaDraw())

    def _layer(self, fn, x):
        """fn(x) -> (x, ...) under a per-layer checkpoint when `cfg.remat`
        and grad is on (the backward recomputes the layer instead of
        keeping its activations)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    # --------------------------- encoder (audio) --------------------------
    def _encode_frames(self, params, frames):
        """frames [B, audio_frames, D] -> the encoder's output, through
        every `enc` layer (non-causal attention over all frames), in the
        frames' dtype or the weights', whichever is wider."""
        cfg = self.cfg
        x = frames
        gp = params["encoder"][0]
        for i in range(cfg.encoder_layers):
            p = _slice(gp, i)
            x = self._layer(
                lambda x, p=p: KIND_TRAIN["enc"](p, x, cfg, {})[0], x)
        return x

    def _base_ctx(self):
        """Per-model ctx: the hybrid arch's attention layers are local
        (RecurrentGemma 1:2) with window `local_window`."""
        if self.cfg.arch_type == "hybrid":
            return {"window": self.cfg.local_window}
        return {}

    def _ctx_from_batch(self, params, batch):
        """The base ctx plus the batch's side input: audio encodes its
        `frames`, vlm passes its `image_embeds` on (a batch without them
        raises KeyError, as the reference's does)."""
        ctx = self._base_ctx()
        if self.cfg.arch_type == "audio":
            ctx["enc_out"] = self._encode_frames(params, batch["frames"])
        if self.cfg.arch_type == "vlm":
            ctx["image_embeds"] = batch["image_embeds"]
        return ctx

    # ------------------------------ train --------------------------------
    def _trunk(self, params, batch):
        """Embed + layer stacks -> (hidden [B,S,D], aux losses {"lb",
        "z"} summed over the layers)."""
        cfg = self.cfg
        ctx = self._ctx_from_batch(params, batch)
        x = embed_tokens(params["embed_block"], batch["tokens"])
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb": zero, "z": zero}
        for (pat, count), gp in zip(layer_groups(cfg), params["groups"]):
            for i in range(count):
                ps = [_slice(gp[j], i) for j in range(len(pat))]

                def body(x, ps=ps, pat=pat):
                    lb = z = zero
                    for j, kind in enumerate(pat):
                        x, a = KIND_TRAIN[kind](ps[j], x, cfg, ctx)
                        lb, z = lb + a["lb"], z + a["z"]
                    return x, lb, z

                x, lb, z = self._layer(body, x)
                aux = {"lb": aux["lb"] + lb, "z": aux["z"] + z}
        return x, aux

    def train_logits(self, params, batch):
        x, aux = self._trunk(params, batch)
        return lm_logits(params["embed_block"], x, self.cfg), aux

    def loss(self, params, batch, seq_chunk: int = 1024):
        """Sequence-chunked softmax cross-entropy: each chunk's logits
        and NLL run under a checkpoint, so the [B,S,V] logits never exist
        whole (recomputed in the backward). S % chunk != 0 takes one
        unchunked pass, as the reference does. -> (ce + LB_COEF * lb +
        Z_COEF * z, {"ce", "lb", "z"})."""
        cfg = self.cfg
        x, aux = self._trunk(params, batch)
        labels = batch["labels"]
        mask = batch.get("loss_mask")
        B, S, D = x.shape
        C = min(seq_chunk, S)
        eb = params["embed_block"]
        if S % C != 0:
            ce = cross_entropy_loss(lm_logits(eb, x, cfg), labels, mask)
        else:
            if mask is None:
                mask = torch.ones((B, S), dtype=torch.float32,
                                  device=x.device)

            def chunk_nll(xc, lc, mc):
                logits = lm_logits(eb, xc, cfg).float()
                logz = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
                return ((logz - gold) * mc).sum(), mc.sum()

            tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
            for c in range(S // C):
                sl = slice(c * C, (c + 1) * C)
                s, m = checkpoint(chunk_nll, x[:, sl], labels[:, sl],
                                  mask[:, sl], use_reentrant=False)
                tot, cnt = tot + s, cnt + m
            ce = tot / torch.clamp(cnt, min=1.0)
        total = ce + LB_COEF * aux["lb"] + Z_COEF * aux["z"]
        return total, {"ce": ce, "lb": aux["lb"], "z": aux["z"]}

    # ----------------------------- prefill -------------------------------
    def prefill(self, params, batch, cache_len=None, true_len=None):
        """true_len (int, optional): number of real prompt tokens when
        `tokens` is padded to a bucket length — padded positions get
        kv_pos = -1 so they can never be attended."""
        cfg = self.cfg
        ctx = self._ctx_from_batch(params, batch)
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
            caches.append(tuple(_stack([pl[j] for pl in per_layer])
                                for j in range(len(pat))))
        return lm_logits(params["embed_block"], x, cfg), caches

    # ------------------------------ decode -------------------------------
    def _decode_trunk(self, params, caches, tokens, ctx):
        """Embed [B,S] tokens and run every layer's decode against the
        caches (written in place) -> logits [B,S,V]."""
        cfg = self.cfg
        x = embed_tokens(params["embed_block"], tokens)
        for (pat, count), gp, gc in zip(layer_groups(cfg), params["groups"],
                                        caches):
            for i in range(count):
                for j, kind in enumerate(pat):
                    x, _ = KIND_DECODE[kind](_slice(gp[j], i), x,
                                             _slice(gc[j], i), cfg, ctx)
        return lm_logits(params["embed_block"], x, cfg)

    def decode_step(self, params, caches, token, pos, batch_ctx=None):
        """token [B] int, pos [B] or scalar int -> (logits [B,V], caches);
        the caches are written in place."""
        ctx = self._base_ctx()
        ctx.update(batch_ctx or {})
        ctx["pos"] = pos
        return self._decode_trunk(params, caches, token[:, None],
                                  ctx)[:, 0], caches

    def decode_span(self, params, caches, tokens, pos, feed_mask=None,
                    batch_ctx=None):
        """Span decode: tokens [B,S] at absolute positions pos[b] + i ->
        (logits [B,S,V], caches). One call scores a whole draft window or
        prefill chunk; feed_mask [B,S] bool gates per-position cache
        writes for ragged spans. Requires supports_span_decode."""
        ctx = self._base_ctx()
        ctx.update(batch_ctx or {})
        ctx["pos"] = pos
        if feed_mask is not None:
            ctx["feed_mask"] = feed_mask
        return self._decode_trunk(params, caches, tokens, ctx), caches

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
        """Zero caches shaped for decode (the serving engine's slot pool);
        attention rings hold min(cache_len, window) positions."""
        cfg = self.cfg
        dtype, dev = dtype_of(cfg), self.device
        w = cfg.local_window if cfg.arch_type == "hybrid" else \
            cfg.sliding_window
        L = min(cache_len, w) if w else cache_len

        def one(kind, lead):
            if kind in ("attn", "moe"):
                return init_kv_cache(cfg, batch_size, L, dtype, dev, lead)
            if kind == "rec":
                return init_rglru_cache(cfg, batch_size, dtype, dev, lead)
            if kind == "cross":
                shape = (*lead, batch_size, cfg.num_image_tokens,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
                return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                        "v": torch.zeros(shape, dtype=dtype, device=dev)}
            if kind == "dec":
                cross = (*lead, batch_size, cfg.audio_frames,
                         cfg.num_kv_heads, cfg.resolved_head_dim)
                return {"self": init_kv_cache(cfg, batch_size, cache_len,
                                              dtype, dev, lead),
                        "cross": {"k": torch.zeros(cross, dtype=dtype,
                                                   device=dev),
                                  "v": torch.zeros(cross, dtype=dtype,
                                                   device=dev)}}
            return init_ssm_cache(cfg, batch_size, dtype, dev, lead)

        return [tuple(one(kind, (count,)) for kind in pat)
                for pat, count in layer_groups(cfg)]


    def init_paged_caches(self, num_pages: int, page_size: int):
        """Global paged KV pool for the engine's paged mode: every
        attention layer holds {"k","v": [count, num_pages, page_size, K,
        Dh]} shared across all decode slots; per-slot page tables ride in
        via batch_ctx["page_table"] on each decode/span call. Requires
        position-addressed, window-free attention throughout."""
        cfg = self.cfg
        if not self.supports_span_decode:
            raise ValueError(
                "paged KV caches need position-addressed decode caches "
                "(attn/moe layer kinds); this arch has recurrent or "
                "side-input state")
        if cfg.sliding_window:
            raise ValueError(
                "paged KV caches do not support sliding-window attention")
        dtype = dtype_of(cfg)
        K, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = lambda count: (count, num_pages, page_size, K, Dh)
        return [tuple({"k": torch.zeros(shape(count), dtype=dtype,
                                        device=self.device),
                       "v": torch.zeros(shape(count), dtype=dtype,
                                        device=self.device)}
                      for _ in pat)
                for pat, count in layer_groups(cfg)]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, device)
