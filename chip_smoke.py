#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and nvcc (CUDA_HOME, PATH or /usr/local/cuda).
Phases, each of which fails the run on any mismatch:

1. The card: name and power limit from nvidia-smi, torch and CUDA
   versions. float32 matmuls stay full f32 (TF32 off for cuBLAS and
   cuDNN), so f32 comparisons are f32-exact up to summation order.
2. Build: every kernel under paddle_tpu_torch/csrc, compiled by nvcc
   for sm_90a into build/paddle_tpu_torch/, with ptxas's register and
   spill report.
3. Kernels: each kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it (ERNIE-base attention, b 32,
   s 512 and 200, 12 heads of 64, read as strided views of a fused qkv
   tensor), causal and not, f32 (tolerance 1e-4) and bf16 (2e-2, the
   Pallas tests' bf16 tolerance); head_dim 128 too. Times with CUDA
   events after warm-up: the kernel, the plain version, and
   torch's scaled_dot_product_attention as the library yardstick (timed
   here only; the port never calls it).
4. Main path: ERNIE-base (bench.py's base config: vocab 30528, hidden
   768, 12 layers, 12 heads, ffn 3072, 512 positions), random weights
   from seed 0, in eval mode on the card, answering request batches of
   32x512, 32x128, 8x384 and 16x200 tokens in f32 and then bf16
   (model.to(torch.bfloat16)). Launch counts are zeroed just before and
   read just after; each forward must launch the attention kernel once
   per layer. Outputs must be finite and of the right shape; the card
   must match a CPU run of the same weights (plain path) on a 2x128
   batch at 1e-3, and bf16 logits must stay within 5e-2 relative L2 of
   f32.

Output: a JSON line per phase; then the `kernels` line, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}. Without CUDA,
or when the repo's paddle_tpu_torch package is not beside this file, it
exits non-zero and prints no result.
"""
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

BASE = dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12,
            num_attention_heads=12, intermediate_size=3072,
            max_position_embeddings=512)
BATCHES = [(32, 512), (32, 128), (8, 384), (16, 200)]
CPU_BATCH = (2, 128)
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# FLOP/s by input type (f32 on the FP32 pipes, bf16 on the tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(b, sq, sk, n, h, causal, dtype_name):
    """Least time on an H100 for one flash forward: the larger of its
    bytes (q, k, v read once, O and lse written once) over the memory
    rate and its flops (QK^T and PV over the pairs this mask keeps)
    over the peak rate of the input type."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = (b * sq * n * h + 2 * b * sk * n * h + b * sq * n * h) * esize \
        + b * n * sq * 4
    pairs = sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk
    flops = 4.0 * b * n * h * pairs
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, fa):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n, h = BASE["num_attention_heads"], \
        BASE["hidden_size"] // BASE["num_attention_heads"]
    cases = [(32, s, n, h, causal, dt)
             for dt in ("float32", "bfloat16")
             for s in (512, 200) for causal in (False, True)]
    cases += [(8, 256, 8, 128, causal, dt)
              for dt in ("float32", "bfloat16") for causal in (False, True)]
    rows = []
    for b, s, nh, hd, causal, dt in cases:
        dtype = getattr(torch, dt)
        # the main path's layout: q, k, v as strided views of one qkv
        qkv = torch.randn((b, s, 3, nh, hd), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / math.sqrt(hd)
        o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        tol = TOL[dt]
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        ok = (torch.allclose(o.float(), o_ref.float(), atol=tol, rtol=tol)
              and torch.allclose(lse, lse_ref, atol=tol, rtol=tol))
        row = dict(dtype=dt, b=b, s=s, n=nh, h=hd, causal=causal,
                   max_abs_err=err_o, lse_max_abs_err=err_lse, tol=tol,
                   ok=bool(ok))
        if not ok:
            emit({"kernel_case": row})
            fail(f"flash_attn_fwd disagrees with its plain version: {row}")
        row["ms"] = time_ms(lambda: fa._flash_fwd_cuda(q, k, v, causal,
                                                       scale), reps=20)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, causal, scale),
            reps=3, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), reps=20)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, s, s, nh, hd, causal, dt)
        emit({"kernel_case": row})
        rows.append(row)
        del qkv, q, k, v, o, lse, o_ref, lse_ref
    torch.cuda.empty_cache()
    return rows


def run_batches(torch, pt, fa, model, dtype_name, gen, keep):
    dev = torch.device("cuda", 0)
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    out = []
    kept = None
    for b, s in BATCHES:
        ids = torch.randint(0, vocab, (b, s), generator=gen, device=dev)
        tt = torch.randint(0, 2, (b, s), generator=gen, device=dev)
        before = fa.launches["flash_attn_fwd"]
        with pt.no_grad():
            logits, nsp = model(ids, tt)
        torch.cuda.synchronize()
        per_forward = fa.launches["flash_attn_fwd"] - before
        if per_forward != layers:
            fail(f"{dtype_name} {b}x{s}: {per_forward} kernel launches in "
                 f"one forward, expected {layers}")
        if tuple(logits.shape) != (b, s, vocab) or \
                tuple(nsp.shape) != (b, 2):
            fail(f"{dtype_name} {b}x{s}: output shapes "
                 f"{tuple(logits.shape)}, {tuple(nsp.shape)}")
        if not (torch.isfinite(logits).all() and torch.isfinite(nsp).all()):
            fail(f"{dtype_name} {b}x{s}: non-finite outputs")
        if (b, s) == keep:
            kept = logits.float().cpu()
        del logits, nsp
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            with pt.no_grad():
                lg, ns = model(ids, tt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del lg, ns
        ms = sorted(times)[2]
        row = dict(dtype=dtype_name, batch=b, seq=s,
                   launches_per_forward=per_forward, latency_ms=ms,
                   tokens_per_s=b * s / (ms / 1e3))
        emit({"main_path": row})
        out.append(row)
    return out, kept


def main_path(torch, pt, fa):
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    cfg = ErnieConfig.base(**BASE)
    pt.seed(SEED)
    model = ErnieForPretraining(cfg, device="cuda").eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    keep = BATCHES[-1]

    fa.launches["flash_attn_fwd"] = 0
    rows, f32_logits = run_batches(torch, pt, fa, model, "float32", gen, keep)
    launches_f32 = fa.launches["flash_attn_fwd"]

    # the card against the CPU, same weights, plain path on the CPU
    b, s = CPU_BATCH
    g = torch.Generator().manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g)
    tt = torch.randint(0, 2, (b, s), generator=g)
    cpu_model = ErnieForPretraining(cfg, device="cpu").eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with pt.no_grad():
        lg_cpu, nsp_cpu = cpu_model(ids, tt)
        lg_gpu, nsp_gpu = model(ids.cuda(), tt.cuda())
    err_lg = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    err_nsp = (nsp_gpu.cpu() - nsp_cpu).abs().max().item()
    cpu_ok = (torch.allclose(lg_gpu.cpu(), lg_cpu, atol=1e-3, rtol=1e-3)
              and torch.allclose(nsp_gpu.cpu(), nsp_cpu, atol=1e-3,
                                 rtol=1e-3))
    emit({"card_vs_cpu": dict(batch=b, seq=s, mlm_max_abs_err=err_lg,
                              nsp_max_abs_err=err_nsp, tol=1e-3,
                              ok=bool(cpu_ok))})
    if not cpu_ok:
        fail("the card's ERNIE-base logits disagree with the CPU run")
    del cpu_model, lg_cpu, nsp_cpu, lg_gpu, nsp_gpu

    model = model.to(torch.bfloat16)
    gen.manual_seed(SEED)  # the same request batches as the f32 pass
    rows_bf16, bf16_logits = run_batches(torch, pt, fa, model, "bfloat16",
                                         gen, keep)
    rel = ((bf16_logits - f32_logits).norm() / f32_logits.norm()).item()
    emit({"bf16_vs_f32": dict(batch=keep[0], seq=keep[1],
                              logits_rel_l2=rel, tol=5e-2,
                              ok=rel <= 5e-2)})
    if not rel <= 5e-2:
        fail(f"bf16 logits drift {rel} from f32 (relative L2 > 5e-2)")
    launches = fa.launches["flash_attn_fwd"]
    if launches == 0:
        fail("the main path launched no flash_attn_fwd kernel")
    return rows + rows_bf16, launches, launches_f32


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not os.path.isfile(os.path.join(REPO, "paddle_tpu_torch",
                                       "__init__.py")):
        fail(f"no paddle_tpu_torch package beside {__file__}: run it from "
             "the root of a checkout")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit({"card": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "tf32": False})

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
        emit({"build": name, "seconds": info["seconds"],
              "cached": info["cached"], "ptxas": ptxas})
    emit({"build_seconds": build_s})

    cases = kernel_phase(torch, fa)
    rows, launches, launches_f32 = main_path(torch, pt, fa)

    head = next(c for c in cases if c["dtype"] == "float32" and c["b"] == 32
                and c["s"] == 512 and not c["causal"])
    emit({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas_kernels.py:175",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases
                           if c["dtype"] == "float32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": "b32 s512 n12 h64 float32 non-causal",
        "launches_float32_pass": launches_f32,
        "cases": cases}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
