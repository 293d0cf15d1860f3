"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the single real CPU device; only
launch/dryrun.py (run as its own process) forces 512 host devices."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root too, so `from tests....` imports (conftest, _hypothesis_stub)
# resolve under a bare `pytest` invocation as well as `python -m pytest`
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the PyTorch port's CUDA "
        "kernels); skips without one")


@pytest.fixture(scope="session")
def tokenizer():
    from repro.core.tokenizer import ByteTokenizer
    return ByteTokenizer(1024)


def _bundle(name, tokenizer):
    from repro.core.grammars import load_grammar
    from repro.core.mask_store import build_mask_store
    from repro.core.constrain import GrammarConstraint
    g, tab = load_grammar(name)
    store = build_mask_store(g, tokenizer)
    return g, tab, store, GrammarConstraint(g, tab, store, tokenizer)


_BUNDLES = {}


@pytest.fixture(scope="session")
def grammar_bundle(tokenizer):
    """factory: grammar_bundle(name) -> (grammar, table, store, constraint)"""
    def get(name):
        if name not in _BUNDLES:
            _BUNDLES[name] = _bundle(name, tokenizer)
        return _BUNDLES[name]
    return get
