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
   for sm_90a into build/paddle_tpu_torch/ (one nvcc per source, all
   started together), with ptxas's register and spill report.
3. Forward kernel: flash_attn_fwd against its plain PyTorch version at
   the inference path's shapes (ERNIE-base attention, b 32, s 512 and
   200, 12 heads of 64, read as strided views of a fused qkv tensor),
   causal and not, f32 (tolerance 1e-4) and bf16 (2e-2, the Pallas
   tests' bf16 tolerance); head_dim 128 too. Times with CUDA events after
   warm-up: the kernel, the plain version, and torch's
   scaled_dot_product_attention as the library yardstick (timed here
   only; the port never calls it).
4. Backward kernels and dropout: flash_attn_bwd_dq and flash_attn_bwd_dkv
   against flash_attention_bwd_plain at the training path's shapes (b 48,
   s 512 and 200, n 12, h 64, strided qkv views), causal and not, f32
   and bf16, head_dim 128; with dropout p = 0.1 at a fixed seed the
   forward and the backward against the plain versions drawing the same
   Philox mask. Tolerance: f32 max abs error <= 1e-4 * max(1, max|ref|),
   bf16 <= 2e-2 * max|ref|. Each backward kernel is timed against the
   plain version of its own outputs (dq, or dk and dv); the library
   yardstick, SDPA's forward + backward minus its forward, computes all
   three gradients and is reported for the whole backward only.
   Mask probe: inputs on which each output element sums a few dropout
   links of equal weight run through the bf16 (tensor-core) and f32
   (FFMA) forward, dQ and dK/dV kernels at b 48, s 512 and 200; each
   must agree with the plain version to within half a link's weight,
   so the kernels' own masks equal the plain Philox mask link for link.
   The kept fraction over all links is reported too.
5. Main path, inference: ERNIE-base (bench.py's base config: vocab
   30528, hidden 768, 12 layers, 12 heads, ffn 3072, 512 positions),
   random weights from seed 0, in eval mode on the card, answering
   request batches of 32x512, 32x128, 8x384 and 16x200 tokens in f32
   and then bf16 (model.to(torch.bfloat16)). Launch counts are zeroed
   just before and read just after; each forward must launch the
   attention kernel once per layer. Outputs must be finite and of the
   right shape; the card must match a CPU run of the same weights
   (plain path) on a 2x128 batch at 1e-3, and bf16 logits must stay
   within 5e-2 relative L2 of f32.
6. Main path, training: bench.py's ERNIE-base pretraining step,
   ErnieForPretraining (dropouts 0.1/0.1) + AdamW(1e-4, weight decay
   0.01) + TrainStep(amp_level="O1", amp_dtype="bfloat16") at batch
   48x512, ids and labels from numpy seed 0; 2 warm-up steps, then 10
   timed steps on a synchronised host clock. Counts are zeroed just
   before the path and read after: every step must launch the forward,
   dQ and dK/dV kernels exactly 12 times each. Losses finite, the last
   below the first (one batch, repeated). Step ms, tokens/s, MFU =
   tokens/s x (6N + 12 L h s) / 989e12 (bench.py's formula) and peak
   memory (torch.cuda.max_memory_allocated).
7. Card against CPU, training: 2 layers of the base width, batch 2x128,
   f32, dropout 0, 3 TrainStep steps from the same weights on the card
   and on the CPU (plain path): losses agree at 1e-3 relative.

8. Profile: torch.profiler over two more training steps, device time
   per step by kernel and by category (`profile` line).

Output: a JSON line per phase; then the
`kernels` line, the card's nvidia-smi line, and last {"ok": true,
"device": {...}}. Without CUDA, or when the repo's paddle_tpu_torch
package is not beside this file, it exits non-zero and prints no result.
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
TRAIN_BATCH = (48, 512)   # bench.py:70's base batch x seq
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
DROP_P, DROP_SEED = 0.1, 1234

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


def _pairs(sq, sk, causal):
    """(query, key) links the mask keeps."""
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_bound_ms(kernel, b, sq, sk, n, h, causal, dtype_name):
    """Least time on an H100 for one backward kernel: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its flops over the peak rate of the input type.
    dQ: q, k, v, dO, lse, delta in, dq out; 3 products (S, dP, dS K).
    dK/dV: the same inputs, dk and dv out; 4 products (S, dP, P^T dO,
    dS^T Q). Each product is 2 h flops per kept (query, key) link."""
    esize = 4 if dtype_name == "float32" else 2
    q_el, k_el = b * sq * n * h, b * sk * n * h
    stats = 2 * b * n * sq * 4
    if kernel == "dq":
        nbytes = (2 * q_el + 2 * k_el + q_el) * esize + stats
        products = 3
    else:
        nbytes = (2 * q_el + 2 * k_el + 2 * k_el) * esize + stats
        products = 4
    flops = products * 2.0 * b * n * h * _pairs(sq, sk, causal)
    return _bound(nbytes, flops, dtype_name)


def _err_ok(got, ref, dt):
    """(max abs error, tolerance, ok): f32 1e-4 * max(1, max|ref|),
    bf16 2e-2 * max|ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    big = ref.float().abs().max().item()
    tol = TOL[dt] * (max(1.0, big) if dt == "float32" else big)
    return err, tol, err <= tol


def _sdpa_fb(torch, q, k, v, do, causal, scale, p):
    """SDPA forward + backward and forward-only callables, [b, s, n, h]
    inputs: the library yardstick of the backward kernels."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return sdpa(qt, kt, vt, is_causal=causal, scale=scale, dropout_p=p)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return fwd, fwd_bwd


def bwd_kernel_phase(torch, fa):
    """The backward kernels (and the forward with dropout) against their
    plain versions at the training path's shapes."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    n, h = BASE["num_attention_heads"], \
        BASE["hidden_size"] // BASE["num_attention_heads"]
    b = TRAIN_BATCH[0]
    cases = [(b, s, n, h, causal, dt, 0.0)
             for dt in ("float32", "bfloat16")
             for s in (512, 200) for causal in (False, True)]
    cases += [(b, 512, n, h, False, dt, DROP_P)
              for dt in ("float32", "bfloat16")]
    cases += [(b, 200, n, h, True, "bfloat16", DROP_P)]
    cases += [(8, 256, 8, 128, causal, dt, 0.0)
              for dt in ("float32", "bfloat16") for causal in (False, True)]
    rows = []
    for b_, s, nh, hd, causal, dt, p in cases:
        dtype = getattr(torch, dt)
        qkv = torch.randn((b_, s, 3, nh, hd), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        do = torch.randn((b_, s, nh, hd), generator=gen, device=dev,
                         dtype=torch.float32).to(dtype)
        scale = 1.0 / math.sqrt(hd)
        o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, p, DROP_SEED)
        dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                        p, DROP_SEED)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                           scale, p, DROP_SEED)
        torch.cuda.synchronize()
        row = dict(dtype=dt, b=b_, s=s, n=nh, h=hd, causal=causal,
                   dropout_p=p)
        ok = True
        for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            err, tol, good = _err_ok(got, want, dt)
            row[f"{name}_max_abs_err"], row[f"{name}_tol"] = err, tol
            ok &= good
        if p:
            o_ref, lse_ref = fa.flash_attention_fwd_plain(
                q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED)
            err, tol, good = _err_ok(o, o_ref, dt)
            row["o_max_abs_err"], row["o_tol"] = err, tol
            row["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
            ok &= good and row["lse_max_abs_err"] <= TOL[dt]
        row["ok"] = bool(ok)
        if not ok:
            emit({"bwd_kernel_case": row})
            fail(f"a backward kernel disagrees with its plain version: {row}")
        lse_c = lse.contiguous()
        delta = fa._bwd_delta(o, do)
        row["dq_ms"] = time_ms(lambda: fa._flash_bwd_dq_cuda(
            q, k, v, do, lse_c, delta, causal, scale, p, DROP_SEED), reps=10)
        row["dkv_ms"] = time_ms(lambda: fa._flash_bwd_dkv_cuda(
            q, k, v, do, lse_c, delta, causal, scale, p, DROP_SEED), reps=10)
        row["delta_ms"] = time_ms(lambda: fa._bwd_delta(o, do), reps=10)
        row["backward_ms"] = row["dq_ms"] + row["dkv_ms"] + row["delta_ms"]
        for kern in ("dq", "dkv"):
            row[f"{kern}_plain_ms"] = time_ms(
                lambda: fa.flash_attention_bwd_plain(
                    q, k, v, o, lse, do, causal, scale, p, DROP_SEED,
                    which=kern), reps=2, warmup=1)
        # SDPA's backward computes dq, dk and dv together: a yardstick for
        # the whole backward (backward_ms), not for one kernel
        lib_f, lib_fb = _sdpa_fb(torch, q, k, v, do, causal, scale, p)
        row["backward_library_ms"] = (time_ms(lib_fb, reps=10)
                                      - time_ms(lib_f, reps=10))
        for kern in ("dq", "dkv"):
            row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = bwd_bound_ms(
                kern, b_, s, s, nh, hd, causal, dt)
        if p:
            row["fwd_ms"] = time_ms(lambda: fa._flash_fwd_cuda(
                q, k, v, causal, scale, p, DROP_SEED), reps=20)
            row["fwd_plain_ms"] = time_ms(
                lambda: fa.flash_attention_fwd_plain(
                    q, k, v, causal, scale, dropout_p=p, seed=DROP_SEED),
                reps=2, warmup=1)
            row["fwd_library_ms"] = time_ms(lib_f, reps=20)
            row["fwd_bound_ms"], row["fwd_bound_by"] = attention_bound_ms(
                b_, s, s, nh, hd, causal, dt)
        emit({"bwd_kernel_case": row})
        rows.append(row)
        del qkv, q, k, v, do, o, lse, dq, dk, dv, ref
        torch.cuda.empty_cache()
    return rows


def mask_probe_phase(torch, fa):
    """The kernels' own dropout masks, link for link. q and k live on
    disjoint halves of head_dim (q[i, c] = 1 where c < h/2 and i % (h/2)
    == c; k[j, c] = 1 where c >= h/2 and j % (h/2) == c - h/2), so QK^T
    = 0 and every probability is 1/s.
    Forward: v[j, c] = 1 where j % h == c, so O[i, c] is the number of
    kept links (i, j) with j % h == c, times w = 1 / (s (1 - p)).
    Backward: v = 1 and dO[i, c] = 1 where i % h == c. Then dV[j, c]
    counts the kept links (i, j) with i % h == c (times w); dQ[i, c],
    c >= h/2, sums keep/(1-p) - delta_i over the keys j % (h/2) == c -
    h/2, and dK[j, c], c < h/2, over the rows i % (h/2) == c (times
    scale/s). Every link lands in one element of each output, so a wrong
    bit moves that element by one link's weight (w, or scale w for dQ and
    dK): each kernel must agree with the plain version (the same Philox
    mask, f32 math) to within half of it. Outputs stay small counts, so
    bf16 rounds them by far less than that."""
    b, n = TRAIN_BATCH[0], BASE["num_attention_heads"]
    h = BASE["hidden_size"] // n
    half = h // 2
    dev = torch.device("cuda", 0)
    scale = 1.0 / math.sqrt(h)
    rows = []
    for dt in ("bfloat16", "float32"):
        for s in (TRAIN_BATCH[1], 200):
            dtype = getattr(torch, dt)
            i = torch.arange(s, device=dev)[:, None]
            c = torch.arange(h, device=dev)[None, :]
            vpat = (i % h == c)[None, :, None, :]
            qkv = torch.zeros((b, s, 3, n, h), device=dev, dtype=dtype)
            qkv[:, :, 0] = ((c < half) & (i % half == c))[None, :, None, :]
            qkv[:, :, 1] = ((c >= half) & (i % half == c - half))[
                None, :, None, :]
            qkv[:, :, 2] = vpat
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            w = 1.0 / (s * (1.0 - DROP_P))
            o, _ = fa._flash_fwd_cuda(q, k, v, False, scale, DROP_P,
                                      DROP_SEED)
            o_ref, _ = fa.flash_attention_fwd_plain(
                q.float(), k.float(), v.float(), False, scale,
                dropout_p=DROP_P, seed=DROP_SEED)
            err = {"o": (o.float() - o_ref).abs().max().item() / w}
            # O / w are counts of kept links, each link in one of them
            kept = ((o.double() / w).round().sum() / (b * n * s * s)).item()
            del o_ref
            qkv[:, :, 2] = 1
            do = vpat.expand(b, s, n, h).to(dtype).contiguous()
            o, lse = fa._flash_fwd_cuda(q, k, v, False, scale, DROP_P,
                                        DROP_SEED)
            got = fa._flash_bwd_cuda(q, k, v, o, lse, do, False, scale,
                                     DROP_P, DROP_SEED)
            ref = fa.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                False, scale, DROP_P, DROP_SEED)
            for name, a, r, unit in zip(("dq", "dk", "dv"), got, ref,
                                        (scale * w, scale * w, w)):
                err[name] = (a.float() - r).abs().max().item() / unit
            row = dict(dtype=dt, b=b, s=s, n=n, h=h, dropout_p=DROP_P,
                       links=b * n * s * s, kept_fraction=kept,
                       expected=1.0 - DROP_P,
                       max_err_in_links=err, tol_in_links=0.5)
            row["ok"] = (all(e < 0.5 for e in err.values())
                         and abs(kept - (1.0 - DROP_P)) < 1e-3)
            emit({"mask_probe": row})
            if not row["ok"]:
                fail(f"a kernel's dropout mask is off: {row}")
            rows.append(row)
            del qkv, q, k, v, o, lse, do, got, ref
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


def _ernie_loss(out, labels):
    from paddle_tpu_torch.models import ErnieForPretraining
    return ErnieForPretraining.pretraining_loss(out, labels)


def _train_batch(torch, vocab, b, s, device):
    """bench.py:102-105: ids and labels from numpy seed 0."""
    import numpy as np
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int64)
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def _zero(fa):
    for k in fa.launches:
        fa.launches[k] = 0


def train_path(torch, pt, fa):
    """ERNIE-base pretraining through TrainStep on the card."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg = ErnieConfig.base(**BASE)
    pt.seed(SEED)
    model = ErnieForPretraining(cfg, device="cuda").train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, _ernie_loss, opt, amp_level="O1",
                     amp_dtype="bfloat16")
    b, s = TRAIN_BATCH
    x, y = _train_batch(torch, cfg.vocab_size, b, s, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    layers = cfg.num_hidden_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _zero(fa)
    losses = []
    per_step = []

    def one():
        before = dict(fa.launches)
        losses.append(step(x, y))
        per_step.append({k: fa.launches[k] - before[k] for k in before})

    for _ in range(TRAIN_WARMUP):
        one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        one()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(fa.launches)
    for i, c in enumerate(per_step):
        if any(v != layers for v in c.values()):
            fail(f"training step {i} launched {c}, expected {layers} of "
                 "each kernel")
    losses = [float(v) for v in losses]
    step_ms = secs / TRAIN_STEPS * 1e3
    tokens_per_s = b * s * TRAIN_STEPS / secs
    flops_per_token = 6.0 * n_params + 12.0 * layers * cfg.hidden_size * s
    mfu = tokens_per_s * flops_per_token / PEAK_FLOPS["bfloat16"]
    row = dict(batch=b, seq=s, amp="O1 bfloat16", dropout=(
        cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob),
        params=n_params, warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
        step_ms=step_ms, tokens_per_s=tokens_per_s,
        flops_per_token=flops_per_token, mfu=mfu,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        launches_per_step=per_step[-1], launches=counts, losses=losses)
    emit({"train_path": row})
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall on a repeated batch: {losses}")
    if not 0 < mfu < 1:
        fail(f"MFU {mfu} is outside (0, 1)")
    return row, (model, step, x, y)


def train_cpu_check(torch, pt, fa):
    """3 f32 TrainStep steps from the same weights on the card and on the
    CPU (plain path), 2 layers of the base width, dropout 0."""
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    cfg = ErnieConfig.base(**dict(BASE, num_hidden_layers=2),
                           hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    pt.seed(SEED + 2)
    gm = ErnieForPretraining(cfg, device="cuda").train()
    cm = ErnieForPretraining(cfg, device="cpu").train()
    cm.load_state_dict({k: v.cpu() for k, v in gm.state_dict().items()})
    b, s = CPU_BATCH
    out = {}
    counts = {}
    for name, m, dev in (("card", gm, "cuda"), ("cpu", cm, "cpu")):
        st = TrainStep(m, _ernie_loss, AdamW(learning_rate=1e-3,
                                             weight_decay=0.01))
        x, y = _train_batch(torch, cfg.vocab_size, b, s, dev)
        _zero(fa)
        out[name] = [float(st(x, y)) for _ in range(3)]
        counts[name] = dict(fa.launches)
    rel = max(abs(a - c) / abs(c) for a, c in zip(out["card"], out["cpu"]))
    # the card ran the kernels (2 layers x 3 steps each), the CPU none
    ran = (all(v == 6 for v in counts["card"].values())
           and not any(counts["cpu"].values()))
    row = dict(layers=2, batch=b, seq=s, dtype="float32",
               losses_card=out["card"], losses_cpu=out["cpu"],
               launches=counts, max_rel_diff=rel, tol=1e-3,
               ok=rel <= 1e-3 and ran)
    emit({"train_card_vs_cpu": row})
    if not row["ok"]:
        fail(f"the card's training losses disagree with the CPU's: {row}")


# kernel-name fragments of the profile's categories, first match wins
PROFILE_CATEGORIES = [
    ("flash attention kernels", ("flash_fwd_", "dq_mma", "dkv_mma",
                                 "dq_simt", "dkv_simt")),
    ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma", "sm90_")),
    ("layer norm", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("embedding", ("embedding", "indexing_backward", "index")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
]


def profile_phase(torch, train_state):
    """Device time by kernel over two training steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    model, step, x, y = train_state
    step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
    # device events only (kernels, copies, sets), not the host ops that
    # launched them, so nothing is counted twice
    by_name = {}
    for ev in prof.events():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        ms, calls = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.time_range.elapsed_us() / 2e3, calls + 1)
    rows = [(ms, name, calls // 2) for name, (ms, calls) in by_name.items()]
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    cats = {}
    for ms, name, _ in rows:
        cat = next((c for c, keys in PROFILE_CATEGORIES
                    if any(k in name for k in keys)), "other elementwise")
        cats[cat] = cats.get(cat, 0.0) + ms
    emit({"profile": dict(steps=2, device_ms_per_step=total,
                          categories=cats, top=[
                              dict(ms=r[0], name=r[1][:90], calls=r[2])
                              for r in rows[:25]])})


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
    bwd_cases = bwd_kernel_phase(torch, fa)
    probes = mask_probe_phase(torch, fa)
    _zero(fa)
    rows, launches_inf, launches_f32 = main_path(torch, pt, fa)
    train, train_state = train_path(torch, pt, fa)
    profile_phase(torch, train_state)
    del train_state
    torch.cuda.empty_cache()
    train_cpu_check(torch, pt, fa)

    # every row at the training path's shape: b 48, s 512, n 12, h 64,
    # bf16, non-causal, dropout 0.1, strided qkv views
    head = next(c for c in bwd_cases if c["dtype"] == "bfloat16"
                and c["b"] == TRAIN_BATCH[0] and c["s"] == 512
                and not c["causal"] and c["dropout_p"])
    shape = "b48 s512 n12 h64 bfloat16 non-causal dropout 0.1"
    by_path = {k: {"inference": launches_inf if k == "flash_attn_fwd"
                   else 0, "training": train["launches"][k]}
               for k in fa.launches}
    # no library call computes one backward kernel's outputs alone: the
    # backward rows carry SDPA's backward beside the whole backward
    common = dict(route="cuda", shape=shape)
    whole_bwd = dict(library_ms=None, backward_ms=head["backward_ms"],
                     backward_library_ms=head["backward_library_ms"])
    kernels = [
        dict(name="flash_attn_fwd",
             source="paddle_tpu_torch/csrc/flash_attn_fwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:175",
             max_abs_err=head["o_max_abs_err"], ms=head["fwd_ms"],
             plain_ms=head["fwd_plain_ms"], bound_ms=head["fwd_bound_ms"],
             bound_by=head["fwd_bound_by"],
             library_ms=head["fwd_library_ms"],
             launches_float32_inference_pass=launches_f32,
             inference_cases=cases),
        dict(name="flash_attn_bwd_dq",
             source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:283",
             max_abs_err=head["dq_max_abs_err"], ms=head["dq_ms"],
             plain_ms=head["dq_plain_ms"], bound_ms=head["dq_bound_ms"],
             bound_by=head["dq_bound_by"], **whole_bwd),
        dict(name="flash_attn_bwd_dkv",
             source="paddle_tpu_torch/csrc/flash_attn_bwd.cu",
             replaces="paddle_tpu/ops/pallas_kernels.py:319",
             max_abs_err=max(head["dk_max_abs_err"], head["dv_max_abs_err"]),
             ms=head["dkv_ms"], plain_ms=head["dkv_plain_ms"],
             bound_ms=head["dkv_bound_ms"], bound_by=head["dkv_bound_by"],
             **whole_bwd)]
    for kern in kernels:
        kern.update(common, launches=by_path[kern["name"]]["training"],
                    launches_by_path=by_path[kern["name"]])
        if kern["launches"] == 0:
            fail(f"the training path launched no {kern['name']} kernel")
    if launches_inf == 0:
        fail("the inference path launched no flash_attn_fwd kernel")
    emit({"kernels": kernels, "philox": "paddle_tpu_torch/csrc/philox.cuh "
          "replaces paddle_tpu/ops/pallas_kernels.py:157 (inside all three)",
          "mask_probes": probes, "backward_cases": bwd_cases})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
