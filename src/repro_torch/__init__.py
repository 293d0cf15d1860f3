"""PyTorch/CUDA port of the SynCode serving system.

The package mirrors `repro`'s layout and names (`repro_torch.core.decoding`
is the counterpart of `repro.core.decoding`, and so on). It imports torch
and numpy, never jax and nothing of `repro`: the pure-Python host layer
(grammar, parser, mask store, constraint, tokenizer, obs, configs) is a
copy kept byte-for-byte equal to the original up to import paths, and
tests/test_torch_isolation.py fails when the two drift apart.

Each Pallas kernel on the served path has a hand-written CUDA kernel for
Hopper (sm_90a) under `csrc/`, built by `kernels/_build.py`.
"""
