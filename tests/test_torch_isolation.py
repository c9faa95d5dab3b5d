"""paddle_tpu_torch stands alone: no jax, nothing of paddle_tpu, and the
card by default with no silent CPU fallback.

The import checks run in a fresh interpreter (this test process has jax
loaded by conftest.py). CUDA is hidden from it with CUDA_VISIBLE_DEVICES
so the no-card behaviour is checked on any machine.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _run(code):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_import_loads_no_jax_and_no_paddle_tpu():
    out = _run(
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.models, "
        "paddle_tpu_torch.nn.functional, paddle_tpu_torch.ops._build, "
        "paddle_tpu_torch.amp, paddle_tpu_torch.optimizer, "
        "paddle_tpu_torch.static, paddle_tpu_torch.ops.philox, "
        "paddle_tpu_torch.ops.extras, paddle_tpu_torch.models.gpt, "
        "paddle_tpu_torch.models.generation, paddle_tpu_torch.serving, "
        "paddle_tpu_torch.serving.engine, paddle_tpu_torch.serving.programs, "
        "paddle_tpu_torch.serving.paged_cache, "
        "paddle_tpu_torch.serving.scheduler, "
        "paddle_tpu_torch.quant, paddle_tpu_torch.quant.int8_serving, "
        "paddle_tpu_torch.observability, "
        "paddle_tpu_torch.observability.sentinel, "
        "paddle_tpu_torch.observability.metrics, "
        "paddle_tpu_torch.observability.goodput, "
        "paddle_tpu_torch.observability.flight_recorder, "
        "paddle_tpu_torch.observability.reqtrace, "
        "paddle_tpu_torch.observability.decisions, "
        "paddle_tpu_torch.observability.timeseries, "
        "paddle_tpu_torch.observability.exporters, "
        "paddle_tpu_torch.observability.pulse_server, "
        "paddle_tpu_torch.observability.watchdog, "
        "paddle_tpu_torch.observability.memory, "
        "paddle_tpu_torch.nn.clip, paddle_tpu_torch.nn.layer.scanned, "
        "paddle_tpu_torch.nn.functional.loss, "
        "paddle_tpu_torch.distributed, "
        "paddle_tpu_torch.distributed.recompute, "
        "paddle_tpu_torch.static.capture, "
        "paddle_tpu_torch.static.train_step, "
        "paddle_tpu_torch.optimizer.optimizers, "
        "paddle_tpu_torch.core.generator\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "print('BAD', bad)\n"
        "print('LIBS', paddle_tpu_torch.ops._build._libs)\n")
    assert "BAD []" in out
    # importing builds and loads no kernel
    assert "LIBS {}" in out


def test_default_device_raises_without_cuda_and_cpu_works():
    out = _run(
        "import torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import ErnieConfig, "
        "ErnieForPretraining\n"
        "assert not torch.cuda.is_available()\n"
        "for fn in (pt.get_device, lambda: ErnieForPretraining("
        "ErnieConfig.tiny()), lambda: pt.to_tensor([1.0])):\n"
        "    try:\n"
        "        fn()\n"
        "        raise SystemExit('no error without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e), e\n"
        "pt.set_device('cpu')\n"
        "print('DEV', pt.get_device())\n"
        "m = ErnieForPretraining(ErnieConfig.tiny()).eval()\n"
        "with pt.no_grad():\n"
        "    lg, nsp = m(torch.zeros((1, 8), dtype=torch.long))\n"
        "print('OUT', tuple(lg.shape), lg.device.type)\n")
    assert "DEV cpu:0" in out
    assert "OUT (1, 8, 1024) cpu" in out


def test_gpt_and_serving_need_cuda_unless_asked_for_the_cpu():
    """GPTForCausalLM, and with it a ServingEngine, and a PagedKVCache
    raise without CUDA unless the CPU was asked for; a CPU model's engine
    follows the model onto the CPU."""
    out = _run(
        "import numpy as np, torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM\n"
        "from paddle_tpu_torch.serving import (PagedKVCache, "
        "ServingConfig, ServingEngine)\n"
        "cfg = GPTConfig.tiny(dropout=0.0)\n"
        "scfg = ServingConfig(max_slots=2, max_admit=1, block_size=4, "
        "n_blocks=8, prefill_buckets=(8,), max_total_tokens=16)\n"
        "for fn in (lambda: GPTForCausalLM(cfg), "
        "lambda: ServingEngine(GPTForCausalLM(cfg), scfg), "
        "lambda: PagedKVCache(1, 4, 4, 1, 4)):\n"
        "    try:\n"
        "        fn()\n"
        "        raise SystemExit('no error without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e), e\n"
        "m = GPTForCausalLM(cfg, device='cpu').eval()\n"
        "eng = ServingEngine(m, scfg)\n"
        "print('POOL', eng.cache.pools[0][0].device.type, eng.device.type)\n"
        "print('OUT', eng.generate_tokens([np.arange(5)], 3))\n"
        "pt.set_device('cpu')\n"
        "print('DEV', next(GPTForCausalLM(cfg).parameters()).device.type)\n")
    assert "POOL cpu cpu" in out
    assert "OUT [[" in out
    assert "DEV cpu" in out


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|paddle_tpu)(\.|\s|$)", re.M)
_FORBIDDEN = ("torch.nn.functional.scaled_dot_product_attention",
              "torch.compile", "cudnn", "flash_attn_interface")


def _port_sources():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert files, "no port sources found"
    return files


def test_no_source_imports_jax_or_paddle_tpu():
    for f in _port_sources() + [REPO / "chip_smoke.py",
                                 REPO / "compare_generate.py"]:
        text = f.read_text()
        hit = _IMPORT.search(text)
        assert hit is None, f"{f.relative_to(REPO)}: {hit.group(0)!r}"


def test_port_calls_no_library_attention():
    for f in _port_sources():
        text = f.read_text()
        for word in _FORBIDDEN:
            assert word not in text, f"{f.relative_to(REPO)} uses {word}"


def test_planes_import_without_torch_and_generate_needs_the_card():
    """The telemetry planes but the sentinel load in an interpreter with
    no torch at all (a dump must work while the card is wedged), and
    generate on a model for the card raises without CUDA rather than
    run on the CPU."""
    out = _run(
        "import sys, importlib.util, types\n"
        "pkg = types.ModuleType('paddle_tpu_torch'); pkg.__path__ = "
        "['paddle_tpu_torch']\n"
        "sub = types.ModuleType('paddle_tpu_torch.observability'); "
        "sub.__path__ = ['paddle_tpu_torch/observability']\n"
        "sys.modules.update({'paddle_tpu_torch': pkg, "
        "'paddle_tpu_torch.observability': sub})\n"
        "import importlib\n"
        "for m in ('metrics', 'goodput', 'flight_recorder', 'reqtrace', "
        "'decisions', 'timeseries', 'exporters', 'pulse_server', "
        "'watchdog', 'memory'):\n"
        "    importlib.import_module('paddle_tpu_torch.observability.' + m)\n"
        "print('TORCH', 'torch' in sys.modules)\n")
    assert "TORCH False" in out
    out = _run(
        "import torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM\n"
        "from paddle_tpu_torch.models.generation import generate_programs\n"
        "cfg = GPTConfig.tiny(dropout=0.0)\n"
        "try:\n"
        "    GPTForCausalLM(cfg).generate(torch.zeros((1, 4), "
        "dtype=torch.long), max_new_tokens=2)\n"
        "    print('RAN')\n"
        "except RuntimeError as e:\n"
        "    print('RAISED', 'set_device' in str(e))\n"
        "m = GPTForCausalLM(cfg, device='cpu').eval()\n"
        "out = m.generate(torch.zeros((1, 4), dtype=torch.long), "
        "max_new_tokens=2)\n"
        "print('CPU', out.device.type, generate_programs(m).programs)\n")
    assert "RAISED True" in out and "RAN" not in out
    # a CPU model runs the eager loop there and builds no program
    assert "CPU cpu 0" in out
