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
        "paddle_tpu_torch.observability.anatomy, "
        "paddle_tpu_torch.observability.xprof, "
        "paddle_tpu_torch.observability.mfu, "
        "paddle_tpu_torch.observability.sentry, "
        "paddle_tpu_torch.observability.calibration, "
        "paddle_tpu_torch.profiler, paddle_tpu_torch.incubate, "
        "paddle_tpu_torch.optimizer.extras, "
        "paddle_tpu_torch.ops.control_flow, "
        "paddle_tpu_torch.nn.clip, paddle_tpu_torch.nn.layer.scanned, "
        "paddle_tpu_torch.nn.functional.loss, "
        "paddle_tpu_torch.distributed, "
        "paddle_tpu_torch.distributed.recompute, "
        "paddle_tpu_torch.static.capture, "
        "paddle_tpu_torch.static.train_step, "
        "paddle_tpu_torch.optimizer.optimizers, "
        "paddle_tpu_torch.core.generator, paddle_tpu_torch.serialization, "
        "paddle_tpu_torch.distributed.chaos, "
        "paddle_tpu_torch.distributed.elastic, "
        "paddle_tpu_torch.distributed.checkpoint, "
        "paddle_tpu_torch.distributed.launch, "
        "paddle_tpu_torch.distributed.elastic_worker, "
        "paddle_tpu_torch.distributed.fleet.utils, "
        "paddle_tpu_torch.distributed.fleet.utils.heartbeat, "
        "paddle_tpu_torch.distributed.fleet.utils.http_server, "
        "paddle_tpu_torch.observability.fleet, "
        "paddle_tpu_torch.serving.fleet, paddle_tpu_torch.serving.loadgen, "
        "paddle_tpu_torch.distributed.env, "
        "paddle_tpu_torch.distributed.collective, "
        "paddle_tpu_torch.distributed.comm, "
        "paddle_tpu_torch.distributed.parallel, "
        "paddle_tpu_torch.distributed.shard_map_util, "
        "paddle_tpu_torch.distributed.rendezvous, "
        "paddle_tpu_torch.distributed.fleet, "
        "paddle_tpu_torch.distributed.fleet.base, "
        "paddle_tpu_torch.distributed.fleet.meta_optimizers, "
        "paddle_tpu_torch.distributed.fleet.metrics, "
        "paddle_tpu_torch.distributed.fleet.metrics.metric, "
        "paddle_tpu_torch.distributed.fleet.utils.fs, "
        "paddle_tpu_torch.io, paddle_tpu_torch.io.dataset, "
        "paddle_tpu_torch.io.sampler, paddle_tpu_torch.io.dataloader, "
        "paddle_tpu_torch.metric, paddle_tpu_torch.jit, "
        "paddle_tpu_torch.jit.api, paddle_tpu_torch.hapi, "
        "paddle_tpu_torch.hapi.model, paddle_tpu_torch.hapi.callbacks, "
        "paddle_tpu_torch.hapi.summary, paddle_tpu_torch.ops.detection, "
        "paddle_tpu_torch.ops.nms, paddle_tpu_torch.models.yolo, "
        "paddle_tpu_torch.vision.ops, paddle_tpu_torch.ops.creation, "
        "paddle_tpu_torch.ops.math, paddle_tpu_torch.ops.manipulation, "
        "paddle_tpu_torch.ops.logic, paddle_tpu_torch.ops.search, "
        "paddle_tpu_torch.ops.stat, paddle_tpu_torch.autograd_utils, "
        "paddle_tpu_torch.regularizer, paddle_tpu_torch.batch, "
        "paddle_tpu_torch.nn.param_attr, paddle_tpu_torch.vision.datasets, "
        "paddle_tpu_torch.vision.transforms, "
        "paddle_tpu_torch.vision.transforms.functional, "
        "paddle_tpu_torch.vision.image, paddle_tpu_torch.nn.layer.rnn, "
        "paddle_tpu_torch.nn.layer.transformer, "
        "paddle_tpu_torch.nn.layer.loss, paddle_tpu_torch.nn.layer.common, "
        "paddle_tpu_torch.nn.decode, paddle_tpu_torch.nn.utils, "
        "paddle_tpu_torch.nn.extension, paddle_tpu_torch.nn.vision, "
        "paddle_tpu_torch.nn.weight_norm_hook, "
        "paddle_tpu_torch.nn.functional.extension, "
        "paddle_tpu_torch.nn.functional.common, "
        "paddle_tpu_torch.ops.rnn_ops, paddle_tpu_torch.ops.loss_extra\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
        "m.startswith('paddle_tpu.')]\n"
        "print('BAD', bad)\n"
        "print('LIBS', paddle_tpu_torch.ops._build._libs)\n")
    assert "BAD []" in out
    # importing builds and loads no kernel
    assert "LIBS {}" in out
    # nor starts a process group
    out = _run("import torch.distributed as d, paddle_tpu_torch\n"
               "import paddle_tpu_torch.distributed.fleet\n"
               "print('PG', d.is_initialized())\n")
    assert "PG False" in out


def test_collect_diagnosis_loads_nothing_of_the_jax_package(tmp_path):
    """The supervisor's doctor bridge loads tools/tpu_doctor.py by path
    and calls only its pure merge: afterwards no module of the JAX
    package, of jax, or the doctor's perf-ledger shim is loaded."""
    for rank, seq in ((0, 8), (1, 5)):
        (tmp_path / f"flight_x_rank{rank}_pid{rank}.json").write_text(
            '{"version": 1, "ts": 1.0, "rank": %d, "world": 2, '
            '"events": [], "collective_seq": {"dp|allreduce_sum": %d}, '
            '"progress": {"steps": 3}}' % (rank, seq))
    out = _run(
        "import sys\n"
        "from paddle_tpu_torch.distributed import elastic\n"
        f"b = elastic.collect_diagnosis({str(tmp_path)!r})\n"
        "print('VERDICT', b['verdict']['kind'], b['verdict']['rank'])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or "
        "m.startswith(('jax.', 'jaxlib', 'paddle_tpu.', "
        "'_pd_analysis_shim'))]\n"
        "print('BAD', bad)\n")
    assert "VERDICT divergence 1" in out
    assert "BAD []" in out


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


def test_yolo_and_the_loader_need_cuda_unless_asked_for_the_cpu():
    """YOLOv3 and a DataLoader's batches go to the card by default and
    raise without one; asked for the CPU, hapi.Model fits and predicts
    there, and hard NMS takes the plain version (no kernel launch)."""
    out = _run(
        "import numpy as np, torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.models import YOLOv3\n"
        "from paddle_tpu_torch.io import DataLoader, TensorDataset\n"
        "from paddle_tpu_torch.ops import nms\n"
        "data = TensorDataset([np.zeros((4, 3), np.float32)])\n"
        "for fn in (lambda: YOLOv3(num_classes=2, width=2), "
        "lambda: next(iter(DataLoader(data, batch_size=2)))):\n"
        "    try:\n"
        "        fn()\n"
        "        raise SystemExit('no error without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e), e\n"
        "m = YOLOv3(num_classes=2, width=2, device='cpu').eval()\n"
        "outs = m(torch.zeros(1, 3, 32, 32))\n"
        "d, c = m.predict(outs, torch.tensor([[32, 32]]))\n"
        "print('DET', tuple(d.shape), d.device.type, nms.launches)\n")
    assert "DET (1, 100, 6) cpu {'nms_greedy': 0}" in out


def test_executor_and_predictor_need_cuda_unless_asked_for_the_cpu():
    """static.Executor() and inference.create_predictor raise without
    CUDA unless given CPUPlace() or Config.disable_gpu(); on the CPU a
    recorded Program runs and a saved model serves, and the Program's
    modules load nothing of the JAX package."""
    out = _run(
        "import sys, tempfile, numpy as np, torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch import static\n"
        "from paddle_tpu_torch.inference import Config, create_predictor\n"
        "from paddle_tpu_torch.jit import InputSpec\n"
        "assert not torch.cuda.is_available()\n"
        "d = tempfile.mkdtemp()\n"
        "m = pt.nn.Linear(4, 2, device='cpu').eval()\n"
        "pt.jit.save(m, d + '/m', input_spec=[InputSpec([None, 4])])\n"
        "for fn in (static.Executor, lambda: create_predictor(Config(d + "
        "'/m'))):\n"
        "    try:\n"
        "        fn()\n"
        "        raise SystemExit('no error without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e) or 'disable_gpu' in str(e), e\n"
        "main = static.Program()\n"
        "with static.program_guard(main):\n"
        "    y = m(static.data('x', [None, 4]))\n"
        "exe = static.Executor(pt.CPUPlace())\n"
        "(r,) = exe.run(main, {'x': np.ones((3, 4), np.float32)}, [y])\n"
        "c = Config(d + '/m')\n"
        "c.disable_gpu()\n"
        "(p,) = create_predictor(c).run([np.ones((3, 4), np.float32)])\n"
        "print('SAME', bool(np.array_equal(r, p)), r.shape)\n"
        "bad = [k for k in sys.modules if k in ('jax', 'paddle_tpu') or "
        "k.startswith(('jax.', 'jaxlib', 'paddle_tpu.'))]\n"
        "print('BAD', bad)\n")
    assert "SAME True (3, 2)" in out
    assert "BAD []" in out


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
                                 REPO / "compare_generate.py",
                                 REPO / "flash_kernel_times.py",
                                 REPO / "smoke_phase_costs.py"]:
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


def test_creation_ops_and_config_1_need_cuda_unless_asked_for_the_cpu():
    """The creation ops (and the random ones), LeNet and the MNIST
    DataLoader's batches go to the card by default and raise without
    one; asked for the CPU, they run there."""
    out = _run(
        "import torch, paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.vision.models import LeNet\n"
        "from paddle_tpu_torch.vision.datasets import MNIST\n"
        "ds = MNIST(mode='test', synthetic_size=8)\n"
        "for fn in (lambda: pt.zeros([2]), lambda: pt.arange(3), "
        "lambda: pt.eye(2), lambda: pt.randn([2]), "
        "lambda: pt.full([2], 1.0), lambda: pt.linspace(0, 1, 3), "
        "lambda: LeNet(), "
        "lambda: next(iter(pt.io.DataLoader(ds, batch_size=4)))):\n"
        "    try:\n"
        "        fn()\n"
        "        raise SystemExit('no error without CUDA')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e), e\n"
        "pt.set_device('cpu')\n"
        "x, y = next(iter(pt.io.DataLoader(ds, batch_size=4)))\n"
        "out = LeNet()(x)\n"
        "print('OUT', tuple(out.shape), out.device.type, "
        "pt.zeros([2]).device.type, pt.randn([2]).device.type)\n")
    assert "OUT (4, 10) cpu cpu cpu" in out


def test_the_rest_of_nn_needs_cuda_unless_asked_for_the_cpu():
    """The layers this slice adds make their parameters on the card by
    default and raise without one (the RNNs, MultiHeadAttention, the
    Transformer, Bilinear, HSigmoidLoss); device="cpu", or the CPU
    asked for, builds them there. The causal mask goes to the current
    device too."""
    out = _run(
        "import paddle_tpu_torch as pt, paddle_tpu_torch.nn as nn\n"
        "makers = [lambda **k: nn.Bilinear(3, 4, 5, **k),\n"
        "          lambda **k: nn.HSigmoidLoss(4, 6, **k),\n"
        "          lambda **k: nn.LSTM(4, 8, num_layers=2, **k),\n"
        "          lambda **k: nn.GRUCell(4, 8, **k),\n"
        "          lambda **k: nn.SimpleRNN(4, 8, **k),\n"
        "          lambda **k: nn.MultiHeadAttention(8, 2, **k),\n"
        "          lambda **k: nn.TransformerDecoderLayer(8, 2, 16, **k),\n"
        "          lambda **k: nn.Transformer(16, 2, 1, 1, 32, **k)]\n"
        "for make in makers:\n"
        "    try:\n"
        "        make()\n"
        "        raise SystemExit('built without a card')\n"
        "    except RuntimeError as e:\n"
        "        assert 'set_device' in str(e), e\n"
        "    assert {p.device.type for p in "
        "make(device='cpu').parameters()} == {'cpu'}\n"
        "try:\n"
        "    nn.Transformer.generate_square_subsequent_mask(4)\n"
        "    raise SystemExit('mask without a card')\n"
        "except RuntimeError:\n"
        "    pass\n"
        "pt.set_device('cpu')\n"
        "print('OK', nn.Transformer(16, 2, 1, 1, 32).decoder.layers[0]"
        ".cross_attn.q_proj.weight.device.type, "
        "nn.Transformer.generate_square_subsequent_mask(4).device.type)\n")
    assert "OK cpu cpu" in out
