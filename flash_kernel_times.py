"""Device times of the flash-attention kernels of the checkout this runs
from, on the card, at chip_smoke.py's kernel shapes.

Run it from the root of a checkout (`python3 flash_kernel_times.py`);
it builds that checkout's csrc/ (ops/_build.py), prints each source's ptxas
lines, then for every case a forward and backward under torch.profiler
(chip_smoke.device_profile, five calls after a warm-up) and each flash
kernel's device ms a call, by name, one JSON line a case. The cases are
chip_smoke.py's kernel shapes, its encoder phases' attention
(ENC256_ATTN, ENC256_ATTN_F32, ENCWIDE_ATTN and ENCWIDE_ATTN_F32), the
f32 cases at 64 and 128 (ERNIE-base's shape, h 128 at b 8, s 256 and
1024) and the f32 head_dim 256 cases at p 0 and 0.1, causal and not;
`--head-dim H` and `--dtype D` keep only the cases of that head_dim
and dtype. To compare two trees on one
card, unpack the older one with `git archive` under a git-ignored
directory and run the script from each root in turns within one command
(older, newer, newer, older): it imports the chip_smoke.py and the
package of the tree it runs from (the working directory), so the newer
tree's script may time the older tree's kernels at the same cases.
"""
import json
import math
import os
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, ROOT)

# b, sq, n, h, causal, dtype, dropout p, sk, separate q, k and v
CASES = [(48, 512, 12, 64, False, "bfloat16", 0.1, 512, False),
         (8, 256, 8, 128, False, "bfloat16", 0.0, 256, False),
         (8, 256, 8, 128, False, "float32", 0.0, 256, False),
         (8, 1024, 8, 256, False, "bfloat16", 0.0, 1024, False),
         (8, 1024, 16, 256, False, "bfloat16", 0.1, 1024, True),
         (8, 1024, 16, 256, False, "float32", 0.1, 1024, True),
         (8, 1024, 8, 512, False, "bfloat16", 0.1, 1024, True),
         (8, 1024, 8, 512, False, "float32", 0.1, 1024, True)]
# the f32 backward at 64 and 128: ERNIE-base's training shape (p 0.1,
# and causal at p 0), the h-128 case causal, and h 128 over the whole
# card (b 8, s 1024) at p 0 and 0.1
CASES += [(48, 512, 12, 64, False, "float32", 0.1, 512, False),
          (48, 512, 12, 64, True, "float32", 0.0, 512, False),
          (8, 256, 8, 128, True, "float32", 0.0, 256, False)]
CASES += [(8, 1024, 8, 128, False, "float32", p, 1024, False)
          for p in (0.0, 0.1)]
CASES += [(8, 1024, 8, 256, causal, "float32", p, 1024, False)
          for p in (0.0, 0.1) for causal in (False, True)]
CASES += [(2, 512, 4, h, causal, dt, p, 512, False)
          for h in (512, 1024) for dt in ("float32", "bfloat16")
          for p in (0.0, 0.1) for causal in (False, True)]


def main():
    import argparse
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    ap = argparse.ArgumentParser()
    ap.add_argument("--head-dim", type=int)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    cases = [c for c in CASES
             if args.head_dim in (None, c[3]) and args.dtype in (None, c[5])]
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"tree": ROOT, "card": cs.nvidia_smi()}), flush=True)
    for name, info in sorted(_build.build().items()):
        print(json.dumps({"build": name, "ptxas": [
            ln.strip() for ln in info["log"].splitlines()
            if "Used" in ln or "spill" in ln]}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    sd = torch.tensor(cs.DROP_SEED, dtype=torch.int64, device="cuda")
    names = [k for keys in cs.KERNEL_EVENTS.values() for k in keys]
    t0 = time.perf_counter()
    for b, s, n, h, causal, dt, p, sk, sep in cases:
        q, k, v = cs.attention_inputs(torch, gen, b, s, sk, n, h,
                                      getattr(torch, dt), sep)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        scale = 1.0 / math.sqrt(h)
        o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)

        def fwd_bwd():
            fa._flash_fwd_cuda(q, k, v, causal, scale, p, sd)
            fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, p, sd)
        top = cs.device_profile(torch, fwd_bwd, 5)["top"]
        ms = {key: sum(r["ms"] for r in top if key in r["name"])
              for key in names}
        print(json.dumps({"case": dict(b=b, s=s, sk=sk, n=n, h=h,
                                       causal=causal, dtype=dt, p=p,
                                       separate=sep),
                          "ms": {key: v for key, v in ms.items() if v}}),
              flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
