"""The port stands alone: nothing under ``src/repro_torch/`` and none of
the tools that drive it import ``jax`` or the JAX package ``repro``, and
``chip_smoke.py`` imports only the port, torch, numpy and the standard
library."""
import ast
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "." * node.level + (node.module or "")
            else:
                yield node.module or ""


def _forbidden(name):
    return name.split(".")[0] in ("jax", "jaxlib", "flax", "repro")


PORT_FILES = sorted(PORT.rglob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(PORT)) for p in PORT_FILES])
def test_port_module_imports_no_jax_or_reference(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the tools that drive the port (timing, ablation) stand alone as well
PORT_TOOLS = sorted(p for p in (ROOT / "tools").glob("*.py")
                    if "repro_torch" in p.read_text())


@pytest.mark.parametrize("path", PORT_TOOLS,
                         ids=[p.name for p in PORT_TOOLS])
def test_port_tool_imports_no_jax_or_reference(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_chip_smoke_imports_only_port_torch_numpy_stdlib():
    allowed = {"repro_torch", "torch", "numpy"} | set(sys.stdlib_module_names)
    names = [n.split(".")[0] for n in _imports(ROOT / "chip_smoke.py")]
    assert not [n for n in names if n not in allowed], names


def test_port_covers_the_slice_layout():
    for rel in ("core/config.py", "core/mask.py", "core/attention.py",
                "kernels/block_sparse.py", "kernels/ref.py",
                "kernels/flash_attention.py", "kernels/paged.py",
                "kernels/registry.py", "kernels/csrc/flash_fwd.cu",
                "kernels/csrc/paged_decode.cu", "models/layers.py",
                "models/transformer.py", "serve/cache.py",
                "serve/scheduler.py", "serve/faults.py", "serve/engine.py",
                "launch/serve.py", "configs/llama_7b.py",
                "configs/llama_gqa.py", "kernels/csrc/flash_bwd.cu",
                "kernels/csrc/flash_bwd_sm90.cu",
                "kernels/csrc/flash_bwd_common.cuh",
                "kernels/csrc/flash_fwd_sm90.cu",
                "kernels/csrc/flash_fwd_common.cuh",
                "kernels/csrc/sm90_common.cuh",
                "core/remat.py", "core/dist_attention.py", "core/tree.py",
                "optim/adamw.py", "train/step.py", "data/pipeline.py",
                "launch/train.py", "core/schedule.py", "parallel/comm.py",
                "parallel/sharding.py", "launch/mesh.py", "launch/world.py",
                "serve/prng.py", "configs/llama_16h.py",
                "configs/llama_33h.py"):
        assert (PORT / rel).is_file(), rel
