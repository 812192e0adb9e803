"""The port stands alone, and the JAX package's state carries into it.

* Nothing under ``src/repro_torch/``, nor ``chip_smoke.py``, imports
  ``jax``, ``jaxlib`` or any ``repro`` module (an AST scan of every
  import, lazy ones inside functions included).
* A CPU sweep, CPU runs of the serving launcher (a dense arch, mixtral,
  RWKV6 and pixtral), the dry-run's CLI on qwen3-0.6b's train_4k cell,
  and the sweep service's CLI and one torch request through it,
  through the port leave ``jax`` and ``repro`` out of ``sys.modules``
  (a fresh interpreter each); the sweep service leaves CUDA
  uninitialised.
* ``repro_torch.carry.import_reference``: a trace saved by ``repro`` loads
  unchanged, the graph's content hash is the same in both packages, and a
  ``repro`` batch sweep's exported orders make a warm port sweep run with
  zero order discoveries.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core import Explorer as RefExplorer
from repro.core.fastsim import FrozenGraph as RefFrozenGraph
from repro.testing import synth as ref_synth

from repro_torch.carry import import_reference
from repro_torch.core import Explorer
from repro_torch.core.fastsim import FrozenGraph
from repro_torch.testing import synth

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_modules(path):
    """Every absolute module name an ``import`` or ``from`` statement in
    ``path`` names (relative imports stay inside the package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"torchsim.py", "lockstep_step.py", "explore.py",
            "chip_smoke.py", "carry.py", "block_matmul.py",
            "cholesky_tiles.py", "ops.py", "ref.py", "traditional.py",
            "flash_attention.py", "layers.py", "attention.py",
            "transformer.py", "registry.py", "qwen3_0_6b.py", "qwen3_4b.py",
            "qwen15_4b.py", "gemma2_2b.py", "engine.py", "serve.py",
            "linear_attn.py", "linear_blocks.py", "rwkv6_1_6b.py",
            "sweepd.py", "coalesce.py", "paraver.py", "moe.py",
            "mixtral_8x22b.py", "llama4_maverick.py", "steptask.py",
            "model.py", "hlsreport.py", "whisper_tiny.py",
            "pixtral_12b.py", "optimizer.py", "step.py", "data.py",
            "checkpoint.py", "supervisor.py", "compression.py",
            "train.py", "sharding.py", "collectives.py", "pipeline.py",
            "mesh.py", "dryrun.py", "analytic.py"} <= names
    port = REPO / "src" / "repro_torch"
    for rel in ("parallel/sharding.py", "parallel/collectives.py",
                "parallel/pipeline.py", "launch/mesh.py", "launch/dryrun.py",
                "roofline/analytic.py"):
        assert (port / rel).is_file(), rel
    assert (port / "serve" / "sweepd.py").is_file()
    assert (port / "serve" / "coalesce.py").is_file()
    assert (port / "core" / "paraver.py").is_file()
    csrc = REPO / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "flash_attention.cu").is_file()
    assert (csrc / "flash_attention_wgmma.cu").is_file()
    assert (csrc / "linear_attn.cu").is_file()
    assert (csrc / "linear_attn_tc.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = [f"{path.name}:{line}: {mod}" for line, mod in imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_cpu_sweep_leaves_jax_and_repro_unimported():
    code = (
        "import sys\n"
        "from repro_torch.core import Explorer\n"
        "from repro_torch.testing.synth import (synth_candidates,\n"
        "                                       synth_reports, synth_trace)\n"
        "res = Explorer(synth_trace(24), synth_reports(), engine='torch',\n"
        "               device='cpu').explore(synth_candidates(range(1, 7)),\n"
        "                                     top_k=3)\n"
        "assert res.best_name == '4acc', res.best_name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


def test_sweep_service_leaves_jax_and_repro_unimported_and_cuda_cold():
    """``client --help`` through the port's CLI, then one torch request
    through an in-process ``SweepService(device="cpu")``: neither ``jax``
    nor ``repro`` is imported, and CUDA is never initialised."""
    code = (
        "import contextlib, io, sys\n"
        "from repro_torch.explore import main\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    try:\n"
        "        main(['client', '--help'])\n"
        "    except SystemExit as done:\n"
        "        assert done.code == 0, done.code\n"
        "from repro_torch.serve.sweepd import SweepService\n"
        "status, doc = SweepService(device='cpu').submit(\n"
        "    '{\"trace\": \"synth:24\", \"engine\": \"torch\"}')\n"
        "assert status == 200 and doc['engine_final'] == 'torch', doc\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr


def serve_launcher_imports(arch):
    """Runs the CPU serving launcher on ``arch`` in a fresh interpreter;
    returns its output, having checked that it left ``jax`` and ``repro``
    unimported."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "assert serve.main(['--device', 'cpu', '--requests', '2',\n"
        "                   '--prompt-len', '6', '--max-new', '3',\n"
        f"                   '--arch', '{arch}']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cpu_serve_launcher_leaves_jax_and_repro_unimported():
    assert "served 2 requests, 6 tokens" in serve_launcher_imports(
        "qwen3-0.6b")


def test_cpu_mixtral_serve_launcher_leaves_jax_and_repro_unimported():
    out = serve_launcher_imports("mixtral-8x22b")
    assert "arch=mixtral-8x22b-smoke" in out
    assert "served 2 requests, 6 tokens" in out


def test_cpu_rwkv6_serve_launcher_leaves_jax_and_repro_unimported():
    out = serve_launcher_imports("rwkv6-1.6b")
    assert "arch=rwkv6-1.6b-smoke" in out
    assert "served 2 requests, 6 tokens" in out


def test_cpu_pixtral_serve_launcher_leaves_jax_and_repro_unimported():
    out = serve_launcher_imports("pixtral-12b")
    assert "arch=pixtral-12b-smoke" in out
    assert "served 2 requests, 6 tokens" in out


def test_cpu_dryrun_cli_leaves_jax_and_repro_unimported():
    """``python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape
    train_4k --device cpu`` (the published config on a fake 16×16 mesh)
    writes its record under ``build/dryrun/`` and imports neither
    ``jax`` nor ``repro``."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--arch', 'qwen3-0.6b', '--shape',\n"
        "            'train_4k', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as done:\n"
        "    assert done.code == 0, done.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
        "             in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    assert "[ok] qwen3-0.6b × train_4k × data=16×model=16" in out.stdout
    assert (REPO / "build" / "dryrun"
            / "qwen3-0.6b__train_4k__data=16×model=16.json").is_file()


def test_import_reference_round_trip(tmp_path):
    """A ``repro`` batch sweep's trace, reports and discovered orders make
    the port's warm sweep replay every lane with zero discoveries."""
    ref_trace = ref_synth.synth_trace(40)
    ref_reports = ref_synth.synth_reports()
    ref_cands = ref_synth.synth_candidates(range(1, 17))
    ref_ex = RefExplorer(ref_trace, ref_reports, engine="batch")
    ref_res = ref_ex.explore(ref_cands, top_k=3)
    assert ref_ex.batch_stats.reference_lanes > 0       # it discovered
    hashes = ref_ex.order_library.take_dirty("availability")
    assert hashes
    orders = {(h, "availability"):
              ref_ex.order_library.export(h, "availability")
              for h in hashes}
    path = str(tmp_path / "trace.jsonl")
    ref_trace.save(path)

    trace, reports, library = import_reference(path, ref_reports, orders)
    assert [e.to_json() for e in trace.events] == \
        [e.to_json() for e in ref_trace.events]
    assert reports == synth.synth_reports()
    # the graph content hash is computed identically by both packages
    ref_graphs = {fg.content_hash() for fg, *_ in ref_ex._graphs.values()
                  if isinstance(fg, RefFrozenGraph)}
    assert set(hashes) <= ref_graphs

    cands = synth.synth_candidates(range(1, 17))
    # batch runs the pinned signatures on the exact path; the torch engine
    # steps the same lanes through their own orders on its lane axis
    stats = {}
    for engine, kw in (("batch", {}), ("torch", {"device": "cpu"})):
        _, _, lib = import_reference(path, ref_reports, orders)
        ex = Explorer(trace, reports, engine=engine, order_library=lib, **kw)
        res = ex.explore(cands, top_k=3)
        port_graphs = {fg.content_hash() for fg, *_ in ex._graphs.values()
                       if isinstance(fg, FrozenGraph)}
        assert port_graphs == ref_graphs
        assert ex.batch_stats.reference_lanes == 0, engine
        assert ex.batch_stats.order_hits > 0, engine
        assert res.best_name == ref_res.best_name
        stats[engine] = ex.batch_stats
    assert stats["batch"].order_pinned_lanes > 0
    assert stats["torch"].order_pinned_lanes == 0
    assert stats["torch"].own_order_lanes == \
        stats["batch"].order_pinned_lanes
    assert len(library) == 0        # staged until a graph claims them
