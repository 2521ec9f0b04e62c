"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

``atoma_infer_tpu_torch`` starts with ``atoma_infer_tpu``, so imports are
matched on the exact top-level package name, never by prefix.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "atoma_infer_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "atoma_infer_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_forbidden_roots_are_matched_exactly(tmp_path):
    sample = tmp_path / "sample.py"
    sample.write_text(
        "import atoma_infer_tpu_torch.ops\n"
        "from atoma_infer_tpu_torch import config\n"
        "from atoma_infer_tpu.ops import kv_cache\n"
        "import jax.numpy as jnp\n"
        "from . import sibling\n"
    )
    roots = [r for r, _ in _imported_roots(str(sample))]
    assert [r for r in roots if r in FORBIDDEN] == ["atoma_infer_tpu", "jax"]


def test_no_jax_or_reference_package_imports():
    offenders = [
        f"{os.path.relpath(path, REPO)}:{line} imports {root}"
        for path in _port_files()
        for root, line in _imported_roots(path)
        if root in FORBIDDEN
    ]
    assert len(_port_files()) > 30
    assert not offenders, offenders


def test_the_tools_subpackage_is_walked():
    walked = {os.path.relpath(p, PORT_DIR) for p in _port_files()}
    tools = {os.path.join("tools", f"{name}.py") for name in (
        "__init__", "w8a8_probe", "w8a8_gate", "kv_quant_gate", "quality_ladder",
        "tiny_corpus", "decode_harness")}
    assert tools <= walked


def test_importing_every_module_leaves_jax_out():
    modules = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)[: -len(".py")].replace(os.sep, ".")
        modules.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


def test_service_without_device_raises_here():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from atoma_infer_tpu_torch.config import EngineConfig
    from atoma_infer_tpu_torch.engine.llm_service import LlmService

    config = EngineConfig.from_dict(
        {"inference": {"model_name": "tiny-random"}, "scheduler": {"max_model_len": 2048}}
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlmService.start(config)
