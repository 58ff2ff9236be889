"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and its entry points refuse to fall back to the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.floe_pair import pair_configs
from repro_torch.core import fusion as FUS
from repro_torch.launch import serve
from repro_torch.models.model import LM
from repro_torch.serving.deployment import ServingDeployment
from _threads import one_thread  # noqa: F401

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ROOT = Path(__file__).resolve().parents[1]


def test_import_all_submodules_leaves_jax_out():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


FEDERATED_MODULES = (
    "repro_torch.core.aggregator", "repro_torch.core.dp",
    "repro_torch.core.rank_select", "repro_torch.core.tree",
    "repro_torch.data.partition", "repro_torch.data.pipeline",
    "repro_torch.data.tasks", "repro_torch.federated.client",
    "repro_torch.federated.server", "repro_torch.federated.simulation",
    "repro_torch.training.checkpoint", "repro_torch.training.optimizer",
    "repro_torch.training.train_step", "repro_torch.launch.train")


def test_federated_modules_stand_alone():
    """The federated slice's modules (the reference's numpy-only ones
    copied, not imported) load without JAX or the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {FEDERATED_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("repro", "jax", "jaxlib"), (path, n)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points run on it")
    scfg, lcfg = pair_configs("2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(scfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FUS.init_alignment(0, scfg.vocab_size)
    slm, llm = LM(scfg, device="cpu"), LM(lcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingDeployment(slm, slm.init(0), llm, llm.init(1),
                          FUS.init_alignment(2, scfg.vocab_size,
                                             device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--local"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--local", "--batch", "4", "--macro-k", "0"])


def test_engine_keyword_form_raises_without_a_card():
    """The engines' keyword form builds its deployment on CUDA unless
    the caller asks for the CPU."""
    from repro_torch.serving.engine import (BatchedHybridEngine,
                                            HybridEngine, SoloEngine)
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points run on it")
    scfg, lcfg = pair_configs("2b")
    slm, llm = LM(scfg, device="cpu"), LM(lcfg, device="cpu")
    sp, lp = slm.init(0), llm.init(1)
    mlp = FUS.init_alignment(2, scfg.vocab_size, device="cpu")
    for build in (lambda: HybridEngine(slm, sp, llm, lp, mlp),
                  lambda: BatchedHybridEngine(slm, sp, llm, lp, mlp),
                  lambda: SoloEngine(slm, sp)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_serve_sample_on_cpu(capsys):
    """``--sample --sample-seed 3`` serves the demo prompts by keyed
    sampling: the sequential engine, the batched engine at K = 8 and its
    per-token step at K = 0 print the same per-request lines (queue
    waits aside: the keys are the rids in every path)."""
    import re

    def lines(argv):
        res = serve.main(["--local", "--device", "cpu", "--sample"] + argv)
        assert all(r.stats.tokens for r in res)
        out = capsys.readouterr().out
        return [re.sub(r" wait=\d+ms", "", ln) for ln in out.splitlines()
                if ln.startswith("[")]
    seq = lines(["--sample-seed", "3"])
    assert len(seq) == 4
    assert lines(["--sample-seed", "3", "--batch", "4"]) == seq
    assert lines(["--sample-seed", "3", "--batch", "4", "--macro-k",
                  "0"]) == seq


def test_serve_refuses_later_slice_flags(capsys):
    import re
    for argv in (["--local", "--mesh-devices", "8"],
                 ["--local", "--batch", "4", "--rules", "fsdp"]):
        with pytest.raises(SystemExit):
            serve.main(argv)
        assert "later slice" in capsys.readouterr().err
    # --spec-k is ported, on the batched engine only
    with pytest.raises(SystemExit):
        serve.main(["--local", "--device", "cpu", "--spec-k", "4"])
    assert "--spec-k requires --batch" in capsys.readouterr().err
    # --max-ctx and --chunk-width are ported: the demo prompts fit the
    # dense row, so the batched run prints the default run's lines
    def lines(argv):
        serve.main(["--local", "--device", "cpu", "--batch", "4"] + argv)
        out = capsys.readouterr().out
        return [re.sub(r" wait=\d+ms", "", ln) for ln in out.splitlines()
                if ln.startswith("[")]
    base = lines([])
    assert len(base) == 4
    assert lines(["--max-ctx", "192", "--chunk-width", "48"]) == base


def test_serve_dense_and_pool_pages_print_the_paged_lines(capsys):
    """``--dense`` (dense lanes) and ``--pool-pages 4`` (a pool that makes
    the second cloud request wait for pages) print the paged run's
    per-request lines, queue waits aside, and the lane KV line names
    the layout."""
    import re

    def run(argv):
        serve.main(["--local", "--device", "cpu", "--batch", "4",
                    "--macro-k", "0"] + argv)
        out = capsys.readouterr().out.splitlines()
        return out[0], [re.sub(r" wait=\d+ms", "", ln) for ln in out
                        if ln.startswith("[")]
    kv_paged, paged = run([])
    assert kv_paged.startswith("lane KV: paged") and len(paged) == 4
    kv, dense = run(["--dense"])
    assert kv.startswith("lane KV: dense") and dense == paged
    kv, small = run(["--pool-pages", "4"])
    assert small == paged and kv != kv_paged


def test_serve_batched_default_is_the_macro_step(capsys):
    """``--batch 4`` without ``--macro-k`` serves at the reference's
    default, K = 8, and prints the same per-request lines (queue waits
    aside) as the per-token step, ``--macro-k 0``."""
    import re

    def lines(argv):
        serve.main(argv + ["--local", "--batch", "4", "--device", "cpu"])
        out = capsys.readouterr().out
        return [re.sub(r" wait=\d+ms", "", ln) for ln in out.splitlines()
                if ln.startswith(("[", "lane KV"))]
    got, per_token = lines([]), lines(["--macro-k", "0"])
    assert len(got) == 5 and got == per_token


def test_serve_gemma3_pair_on_cpu(capsys):
    """``--pair gemma3 --device cpu`` serves the four demo prompts on the
    reduced gemma3 pair, sequentially and batched on paged lanes with
    ring-local pools (the pool capacity counts them), the private
    prompts on the edge; the macro step prints the per-token step's
    lines."""
    import re

    def lines(argv):
        res = serve.main(argv + ["--local", "--pair", "gemma3", "--device",
                                 "cpu"])
        assert [r.stats.private for r in res] == [False, True, False, True]
        assert all(r.stats.tokens == 8 for r in res)
        out = capsys.readouterr().out
        return [re.sub(r" wait=\d+ms", "", ln) for ln in out.splitlines()
                if ln.startswith(("[", "lane KV"))]
    assert len(lines([])) == 4
    got = lines(["--batch", "4"])
    assert got == lines(["--batch", "4", "--macro-k", "0"])
    # f32 K and V pages of 16 slots over 1 KV head (SLM) or 2 (LLM) of
    # 32: per lane row 6 block pages of the SLM's global layer and the
    # LLM's 2 layers (cloud lane), and 1 ring page of its local layer
    slm_page, llm_page = 2 * 16 * 32 * 4, 2 * 2 * 16 * 2 * 32 * 4
    want = 4 * (6 * (slm_page + llm_page) + slm_page) \
        + 4 * (6 * slm_page + slm_page)
    assert got[0] == f"lane KV: paged, pool capacity {want}B"


def test_serve_refuses_other_page_sizes_on_cuda(monkeypatch, capsys):
    """The paged decode kernel takes 16-slot pages: on CUDA the launcher
    refuses any other ``--page-size`` before it builds a model."""
    import repro_torch
    monkeypatch.setattr(repro_torch, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    with pytest.raises(SystemExit):
        serve.main(["--local", "--batch", "4", "--macro-k", "0",
                    "--page-size", "8"])
    assert "--page-size 8" in capsys.readouterr().err
