"""Import and routing hygiene of the port (silent_speech_tpu_torch).

- Importing every module leaves jax and every module of the JAX package
  out of sys.modules and needs neither nvcc nor a CUDA device (checked in a
  fresh subprocess); no source of the port, nor chip_smoke.py, names the
  JAX package or jax in an import statement (checked on the syntax tree).
- impl='kernel' on a CPU tensor raises; so do the JAX package's serving
  knob values the port does not have.
- The measurement scripts (silent_speech_tpu_torch/scripts) are among the
  modules both checks reach.
- A kernel build without nvcc raises instead of falling back.
"""

import ast
import glob
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

from silent_speech_tpu_torch.infer.predictor import Predictor
from silent_speech_tpu_torch.models.bigru import (BiGRUClassifier,
                                                  BiGRUConfig, init_params)
import silent_speech_tpu_torch
from silent_speech_tpu_torch.ops import (_kernels, cuda_bwd_dots, cuda_cnn,
                                         cuda_dot_chain, cuda_gru,
                                         cuda_gru_proto, cuda_layout_micro,
                                         cuda_mm_rate)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import silent_speech_tpu_torch as pkg
mods = [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
    pkg.__path__, prefix=pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "silent_speech_tpu"))
assert not bad, bad
print("port-hygiene ok: %d modules" % len(mods))
"""


def test_port_imports_no_jax_and_needs_no_cuda():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_VISIBLE_DEVICES="")
    env.pop("CUDA_HOME", None)
    proc = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "port-hygiene ok" in proc.stdout


def _imported_roots(path: str) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


_PORT_SOURCES = sorted(glob.glob(os.path.join(
    REPO, "silent_speech_tpu_torch", "**", "*.py"), recursive=True)) + [
    os.path.join(REPO, "chip_smoke.py")]


@pytest.mark.parametrize("path", _PORT_SOURCES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_nothing_of_jax(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "silent_speech_tpu"}


@pytest.mark.parametrize("script", ["bench_gru", "proto_gru2", "proto_gru3",
                                    "proto_gru4", "proto_parity_cnn",
                                    "proto_parity_e2e", "proto_ablate",
                                    "probe_front", "probe_int8",
                                    "bench_fused_cnn", "mosaic_micro",
                                    "proto_bwd_dots", "proto_bwd_dots2",
                                    "proto_bwd_dots3"])
def test_scripts_subpackage_is_checked(script):
    """The fresh-process import check walks the scripts subpackage, and the
    syntax-tree scan reads its sources."""
    walked = {m.name for m in pkgutil.walk_packages(
        silent_speech_tpu_torch.__path__, prefix="silent_speech_tpu_torch.")}
    assert f"silent_speech_tpu_torch.scripts.{script}" in walked
    assert os.path.join(REPO, "silent_speech_tpu_torch", "scripts",
                        f"{script}.py") in _PORT_SOURCES


def test_import_scan_sees_the_jax_package(tmp_path):
    """The scan catches every spelling of an import of the JAX package."""
    for line in ("import silent_speech_tpu", "import silent_speech_tpu.ops",
                 "from silent_speech_tpu.core import schema",
                 "from silent_speech_tpu import core",
                 "def f():\n    import jax.numpy as jnp"):
        f = tmp_path / "m.py"
        f.write_text(line + "\n")
        assert _imported_roots(str(f)) & {"jax", "silent_speech_tpu"}, line
    f.write_text("import silent_speech_tpu_torch\nfrom . import x\n")
    assert not _imported_roots(str(f)) & {"jax", "silent_speech_tpu"}


def test_kernel_impl_on_cpu_tensor_raises():
    g = torch.Generator().manual_seed(0)
    roi = torch.zeros((2, 48, 96), dtype=torch.uint8)
    params = init_params(BiGRUConfig(x_dim=4, hidden=8, head_hidden=4), g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_cnn.roi_cnn_fused(roi, params["roi_cnn"], impl="kernel")
    x = torch.zeros((2, 3, 36))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_gru.bigru_kernel(x, torch.tensor([3, 1]), params["gru"],
                              impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        cuda_gru.gru_layer(x, torch.tensor([3, 1]), params["gru"][0]["fwd"],
                           impl="pallas")


@pytest.mark.parametrize("wrapper", ["kstep", "kstep_2w", "dual", "mm_rate",
                                     "dot_chain", "layout_micro",
                                     "bwd_dot_tt", "bwd_dot_xp", "bwd_dot_nt",
                                     "bwd_dot_base", "bwd_dot_nn"])
def test_probe_kernel_impl_on_cpu_tensor_raises(wrapper):
    H = 8
    xp, lengths = torch.zeros((2, 3, 3 * H)), torch.tensor([3, 1])
    wh, bh = torch.zeros((H, 3 * H)), torch.zeros(3 * H)
    p = {"wi": torch.zeros((4, 3 * H)), "bi": bh, "wh": wh, "bh": bh}
    x = torch.zeros((2, 3, 4))
    call = {"kstep": lambda: cuda_gru_proto.gru_sequence_kstep(
                xp, lengths, wh, bh, impl="kernel"),
            "kstep_2w": lambda: cuda_gru_proto.gru_sequence_kstep_2w(
                xp, lengths, wh[None].expand(2, -1, -1),
                bh[None].expand(2, -1), impl="kernel"),
            "dual": lambda: cuda_gru_proto.gru_layer_dual(
                x, x, lengths, p, p, impl="kernel"),
            "mm_rate": lambda: cuda_mm_rate.mm_rate(
                torch.zeros((4, 8)), torch.zeros((8, 4)), impl="kernel"),
            "dot_chain": lambda: cuda_dot_chain.dot_chain(
                torch.zeros((8, 128), dtype=torch.uint8),
                torch.zeros((384, 384)), "f32", impl="kernel"),
            "layout_micro": lambda: cuda_layout_micro.layout(
                "copy", torch.zeros((768, 768)), impl="kernel"),
            "bwd_dot_tt": lambda: cuda_bwd_dots.bwd_dot_tt(
                torch.zeros((16, 8)), torch.zeros((16, 4)), 8, impl="kernel"),
            "bwd_dot_xp": lambda: cuda_bwd_dots.bwd_dot_xp(
                torch.zeros((16, 8)), torch.zeros((16, 4)), 8, impl="kernel"),
            "bwd_dot_nt": lambda: cuda_bwd_dots.bwd_dot_nt(
                torch.zeros((16, 4)), torch.zeros((8, 4)), 8, impl="kernel"),
            "bwd_dot_base": lambda: cuda_bwd_dots.bwd_dot_base(
                torch.zeros((16, 8)), torch.zeros((8, 4)), 8, impl="kernel"),
            "bwd_dot_nn": lambda: cuda_bwd_dots.bwd_dot_nn(
                torch.zeros((8, 16)), torch.zeros((16, 4)), 2,
                impl="kernel")}[wrapper]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


@pytest.mark.parametrize("knob,value", [
    ("roi_impl", "grouped"), ("roi_impl", "pallas"), ("roi_impl", "fused"),
    ("roi_impl", "xla"), ("gru_impl", "scan"), ("gru_impl", "pallas"),
    ("roi_variant", "stacked"), ("roi_variant", "wide"),
    ("compute_dtype", "float16"), ("matmul_precision", {"head": "highest"}),
    ("matmul_precision", "high"),
])
def test_jax_only_knob_values_raise(knob, value):
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    with pytest.raises(ValueError, match=knob):
        Predictor(model=model, id_to_label=dict(enumerate("abcdefghij")),
                  device="cpu", **{knob: value})


def test_jax_roi_impl_pallas_names_the_im2col_variant():
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    with pytest.raises(ValueError, match="roi_variant='im2col'"):
        Predictor(model=model, id_to_label={}, device="cpu",
                  roi_impl="pallas")
    for variant in ("tiled3", "tiled3_q8", "im2col"):
        for dtype in ("float32", "bfloat16"):
            Predictor(model=model, id_to_label={}, device="cpu",
                      roi_variant=variant, compute_dtype=dtype)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model=model, id_to_label={}, device="cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("knobs", [{"roi_variant": "tiled3_q8"},
                                   {"roi_variant": "im2col"},
                                   {"compute_dtype": "bfloat16"}])
def test_serving_modes_refuse_training_and_q8_refuses_standardize(knobs):
    cfg = BiGRUConfig(x_dim=4, hidden=8, head_hidden=4, roi_emb=4)
    model = BiGRUClassifier.from_jax_params(
        init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    X, L = torch.zeros((2, 3, 4)), torch.tensor([3, 2])
    R = torch.zeros((2, 3, 48, 96), dtype=torch.uint8)
    with pytest.raises(ValueError, match="serving-only"):
        model.forward(X, L, R, train=True, generator=torch.Generator(),
                      **knobs)
    with torch.no_grad():
        model.live_forward(X, L, R, **knobs)
        if knobs.get("roi_variant") == "tiled3_q8":
            with pytest.raises(ValueError, match="serving-only"):
                model.forward(X, L, R, roi_standardize=True, **knobs)
    with pytest.raises(ValueError, match="compute_dtype"):
        model.live_forward(X, L, R, compute_dtype="float16")
