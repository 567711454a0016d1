"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package ``repro``,
and the port's entry points refuse to run on a missing GPU unless the
caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_analytic_core_modules_are_held_to_the_import_check():
    names = {str(f.relative_to(ROOT)) for f in FILES}
    for rel in ("core/costmodel.py", "core/converter.py",
                "core/pipeline.py", "launch/analytic.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_training_modules_are_held_to_the_import_check():
    names = {str(f.relative_to(ROOT)) for f in FILES}
    for rel in ("training/optimizer.py", "training/train_loop.py",
                "training/checkpoint.py", "data/synthetic.py",
                "launch/train.py", "tree.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_mesh_modules_are_held_to_the_import_check():
    names = {str(f.relative_to(ROOT)) for f in FILES}
    for rel in ("launch/mesh.py", "core/disagg.py",
                "core/attention_parallel.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_dry_run_modules_are_held_to_the_import_check():
    names = {str(f.relative_to(ROOT)) for f in FILES}
    for rel in ("launch/entrypoints.py", "launch/dryrun.py",
                "launch/hlo_analysis.py", "launch/roofline.py",
                "configs/base.py"):
        assert f"src/repro_torch/{rel}" in names, rel


def test_the_port_has_every_module_of_the_reference():
    """``comm -23`` of the two packages' module lists is empty."""
    ref = {p.relative_to(ROOT / "src" / "repro")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(PORT) for p in PORT.rglob("*.py")}
    assert sorted(str(p) for p in ref - port) == []


def test_the_dry_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_one("tinyllama-1.1b", "decode_32k", multi_pod=False,
                       mode="natural", out_dir=str(tmp_path))
    assert not dist.is_initialized()


def test_every_port_module_names_its_reference():
    for path in PORT.rglob("*.py"):
        if path.name == "__init__.py" and path.parent != PORT and \
                not path.read_text().strip():
            continue
        if path.name == "_cuda.py":
            continue                       # build helper, no reference
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        assert "repro/" in doc or "src/repro" in doc, path


def test_cuda_sources_name_the_tpu_kernel_they_replace():
    for cu in (PORT / "csrc").glob("*.cu"):
        text = cu.read_text()
        assert "Replaces the TPU kernel repro/kernels/" in text, cu
        assert "What bounds it" in text and "design" in text, cu


def test_default_device_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.serving import LLMEngine, PagedKVCache

    cfg = registry.get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(cfg, 8, 4)
    params = transformer.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.prefill(params, cfg, {"tokens": [[1, 2, 3]]}, max_seq=3)
    from repro_torch.launch import serve
    from repro_torch.serving.cluster import (DecodeEngine, DisaggCluster,
                                             PrefillEngine)
    for entry in (DisaggCluster, PrefillEngine, DecodeEngine):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3-8b", "--smoke", "--mode", "router",
                    "--requests", "2"])
    # the moe family and the moe_offload placement
    mcfg = registry.get_smoke_config("qwen3-moe-30b-a3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, mcfg)
    mparams = transformer.init_params(0, mcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(mcfg, mparams, placement="moe_offload")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--placement",
                    "moe_offload", "--requests", "2"])
    # the audio family's entry points, and the converter's executable graph
    acfg = registry.get_smoke_config("seamless-m4t-medium")
    aparams = transformer.init_params(0, acfg, device="cpu")
    batch = {"tokens": [[1, 2]], "frames": torch.zeros(1, 3, acfg.d_model)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(0, acfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(acfg, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.forward(aparams, acfg, batch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.prefill(aparams, acfg, batch, max_seq=4)
    _, acache = transformer.prefill(aparams, acfg, batch, max_seq=4,
                                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.decode_step(aparams, acfg, [1], acache)
    from repro_torch.core import converter
    with pytest.raises(RuntimeError, match="device='cpu'"):
        converter.build_block_graph(cfg, weights=transformer._layer(
            params["layers"], 0), batch=1)


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import packed_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import train

    cfg = registry.get_smoke_config("tinyllama-1.1b")
    params = transformer.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.loss_fn(params, cfg, {"tokens": [[1, 2]]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, opt.AdamWConfig(), packed_batches(cfg.vocab_size, 1, 8),
              1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps",
                        "1"])


def test_init_params_on_cpu_is_seeded_and_follows_the_init_rules():
    from repro_torch.configs import registry
    from repro_torch.models import transformer

    cfg = registry.get_smoke_config("gemma2-27b")
    a = transformer.init_params(0, cfg, device="cpu")
    b = transformer.init_params(0, cfg, device="cpu")
    c = transformer.init_params(1, cfg, device="cpu")
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["layers"]["attn"]["wq"],
                           c["layers"]["attn"]["wq"])
    assert "lm_head" not in a                 # tied embeddings
    assert a["layers"]["attn"]["wo"].shape == (cfg.num_layers, 4, 64, 256)
    assert not torch.equal(a["layers"]["ffn"]["w_up"][0],
                           a["layers"]["ffn"]["w_up"][1])
    assert float(a["layers"]["norm1"].abs().max()) == 0.0


def test_chip_smoke_exits_nonzero_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120,
                          env=env, cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
