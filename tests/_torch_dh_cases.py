"""The worlds of tests/test_torch_dh_shard.py, run by every rank of a
trunk-sharded engine (gloo ranks through `repro_torch.launch.mesh.spawn`)
and, unsharded, in the test process. Imports nothing of JAX, so the
spawned ranks start quickly: the test hands them the reference's weights
as numpy leaves. Imported by its bare name, as
`tests/_torch_trunk_cases.py` is.

M divides neither the kv heads nor a cache length in these worlds, so
each kind of cache takes the reference's head_dim branch or keeps the
whole leaf (`TrunkPlan.cache` for the dense caches, `.pool` for the page
pools), on the fp32 narrow configs of `_torch_trunk_cases` (head_dim
32) and the narrow hybrid of `_torch_recurrent_cases` with its local
window cut to 13 positions:
  * M = 2: "seq" (6/3 heads) served at max_len 47, pages of 9: the
    dense cache and the pool both on head_dim, 16 channels a rank; the
    hybrid's ring of 13 on head_dim;
  * M = 3: "dense" (8/4 heads) served at max_len 47, pages of 8: both
    whole; the MoE "seq_moe" (8/2 heads) at 47 whole; the hybrid's
    ring whole;
  * M = 4: "seq" served at max_len 48, pages of 9: the dense cache on
    the sequence (12 positions a rank) beside a pool on head_dim (8
    channels); "seq_moe" at 47 and the hybrid's ring on head_dim, 8
    channels;
and at M = 1 (this process, nothing split) the model case of each. The
serving config runs every case of `_torch_sharded_cases.run_cases`
(at M = 4 the sequence-split ring beside the head_dim pool); the hybrid
runs `_torch_recurrent_cases.run_cases` at M = 2 and 3.
"""
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_serving_mesh
import _torch_recurrent_cases as R
import _torch_sharded_cases as S
import _torch_trunk_cases as C

# M -> (config of _torch_trunk_cases, max_len, page_size) served
SERVED = {1: ("seq", 47, 9), 2: ("seq", 47, 9), 3: ("dense", 47, 8),
          4: ("seq", 48, 9)}
# M -> the branches (dense cache, pool) of SERVED[M]
BRANCHES = {1: (None, None), 2: ("dh", "dh"), 3: ("whole", "whole"),
            4: ("seq", "dh")}
# the model case's MoE (8/2 heads, E 8) and its dense caches' length
MOE, MOE_LEN = "seq_moe", 47
# the hybrid's local window: a ring of 13 positions
WINDOW = 13
HYBRID_CASES = (2, 3)   # worlds that serve the hybrid's cases


def hybrid_config(get=get_config):
    return replace(R.config("hybrid", get), local_window=WINDOW)


def world(rank, n, payload):
    """One gloo rank of a spawned world of n ranks (n 1: this process, no
    group): SERVED[n]'s model case and (above M = 1) its serving cases,
    the MoE's and the hybrid's model cases, the hybrid's serving cases
    where HYBRID_CASES names n."""
    mesh = make_serving_mesh(n, device="cpu")
    name, max_len, page = SERVED[n]
    params_np, tok, bundles, toks = payload[name]
    cfg = C.config(name)
    out = {"served": {"model": C.model_case(mesh, cfg, params_np, toks,
                                            max_len, page)}}
    if n > 1:
        out["served"]["cases"] = S.run_cases(
            mesh, C.V, params_np, tok, bundles, cfg=cfg, trunk_shard=True,
            max_len=max_len, long=True, page_size=page)
    params_np, _, _, toks = payload[MOE]
    out["moe"] = C.model_case(mesh, C.config(MOE), params_np, toks,
                              MOE_LEN)
    params_np, _, _, toks = payload["hybrid"]
    out["hybrid"] = {"model": R.model_case(mesh, hybrid_config(),
                                           params_np, toks)}
    if n in HYBRID_CASES:
        out["hybrid"]["cases"] = R.run_cases(mesh, "hybrid",
                                             payload["hybrid"],
                                             cfg=hybrid_config())
    return out


def unsharded(payload):
    """The one-device tokens every world is held to: the serving cases
    of each (config, max_len, page) SERVED names above M = 1, and the
    hybrid's cases -> {(name, max_len, page) or "hybrid": cases}."""
    out = {}
    for n in (2, 3, 4):
        key = SERVED[n]
        if key not in out:
            params_np, tok, bundles, _ = payload[key[0]]
            out[key] = S.run_cases(None, C.V, params_np, tok, bundles,
                                   cfg=C.config(key[0]), trunk_shard=True,
                                   max_len=key[1], long=True,
                                   page_size=key[2])
    out["hybrid"] = R.run_cases(None, "hybrid", payload["hybrid"],
                                cfg=hybrid_config())
    return out
