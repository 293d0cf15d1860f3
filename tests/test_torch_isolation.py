"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package, and its copy of the pure-Python host layer stays equal
to the original up to import paths, so drift fails here instead of
forking silently."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# host-layer modules the port keeps as copies (path relative to the
# package root, identical under src/repro and src/repro_torch)
COPIED = [
    "core/__init__.py", "core/tokenizer.py", "core/regex.py",
    "core/grammar.py", "core/lexer.py", "core/lr.py", "core/parser.py",
    "core/mask_store.py", "core/constrain.py", "core/sampling.py",
    "core/grammars/__init__.py",
    "core/grammars/builtin_defs.py", "obs/__init__.py", "obs/registry.py",
    "obs/lifecycle.py", "obs/trace.py", "obs/buildinfo.py",
    "obs/devtime.py", "obs/telemetry.py", "models/config.py",
    "configs/syncode_demo.py", "configs/smollm_360m.py",
    "configs/qwen3_moe_30b_a3b.py", "configs/mamba2_370m.py",
    "configs/recurrentgemma_9b.py", "configs/whisper_base.py",
    "configs/llama3_2_vision_90b.py", "configs/qwen1_5_0_5b.py",
    "configs/internlm2_1_8b.py", "configs/deepseek_coder_33b.py",
    "configs/kimi_k2_1t_a32b.py",
    "spec/__init__.py", "spec/jump.py", "spec/proposer.py",
    "spec/scheduler.py", "serving/kvpool/__init__.py",
    "serving/kvpool/allocator.py",
]


def _rewrite_imports(text: str) -> str:
    return re.sub(r"^(\s*)(from|import) repro\.", r"\1\2 repro_torch.",
                  text, flags=re.M)


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with jax blocked and leaves no
    jax or repro module behind."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None\n"
        "             and (k == 'repro' or k.startswith(('repro.', 'jax'))))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_top_level_names_are_defined_once(path):
    """A second `def` or `class` of a module-level name silently replaces
    the first, and every caller of the first then reaches the second."""
    seen = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            assert node.name not in seen, (path, node.name, node.lineno)
            seen.add(node.name)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_host_module_matches_reference(rel):
    orig = (SRC / "repro" / rel).read_text()
    copy = (PORT / rel).read_text()
    assert copy == _rewrite_imports(orig), (
        f"src/repro_torch/{rel} drifted from src/repro/{rel}: re-copy it "
        f"(rewriting only `repro.` imports to `repro_torch.`)")


def test_config_registry_is_the_reference_subset():
    """configs/__init__.py keeps the reference's code with only the
    ported configs registered (all of them since the vlm family and the
    four remaining text configs were ported)."""
    orig = (SRC / "repro" / "configs" / "__init__.py").read_text()
    keep = {"syncode-demo", "smollm-360m", "qwen3-moe-30b-a3b",
            "mamba2-370m", "recurrentgemma-9b", "whisper-base",
            "llama-3.2-vision-90b", "qwen1.5-0.5b", "internlm2-1.8b",
            "deepseek-coder-33b", "kimi-k2-1t-a32b"}
    lines = [ln for ln in orig.splitlines(keepends=True)
             if not (re.match(r'\s+"[^"]+": "[^"]+",\n', ln)
                     and ln.split('"')[1] not in keep)]
    want = _rewrite_imports("".join(lines)).replace(
        'f"repro.configs.', 'f"repro_torch.configs.')
    assert (PORT / "configs" / "__init__.py").read_text() == want
