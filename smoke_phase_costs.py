"""What the slowest parts of chip_smoke.py cost on the card, for keeping
the smoke inside its time limit.

Run it from the root of a checkout (`python3 smoke_phase_costs.py`): it
builds csrc/ (ops/_build.py) and prints one JSON line of host seconds,
each taken around work that ends in torch.cuda.synchronize():

- `profile_trivial_*`: three chip_smoke.device_profile sessions over
  one small add (the first pays the profiler's start-up);
- `ernie_*`: the capture and one replay of captured_train's ERNIE-base
  O1 step, then profile_step over it (three rounds of three calls);
- `raw_*`: one torch.profiler session over two replays of that step,
  with the CPU and CUDA activities or CUDA alone, with and without
  reading its events (`events_*`: how many);
- `gen_*`: GPT-2 small's captured generate() in bf16 at GEN_SHAPE (the
  first call, which captures, a second, the eager loop, and
  device_profile over a whole call and over the prefill and finish
  graphs), the f32 first call and eager loop, and the same bf16 parts
  at GEN_CAPTURE_SHAPE (`gen64_*`).

It needs one card; without one it exits 1.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("smoke_phase_costs: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as cs
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.generation import generate_programs
    from paddle_tpu_torch.ops import _build
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    _build.build()
    out = {"card": cs.nvidia_smi(), "build_s": time.perf_counter() - t}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = round(time.perf_counter() - t0, 3)
        return r

    x = torch.ones(1024, device="cuda")
    for i in range(3):
        timed(f"profile_trivial_{i}", lambda: cs.device_profile(
            torch, lambda: x.add_(1), 1))
    model = cs._train_model(pt, "ernie")
    step, xx, yy, _, _ = cs._train_step(torch, "ernie", model)
    timed("ernie_capture", lambda: step(xx, yy))
    timed("ernie_replay", lambda: step(xx, yy))
    timed("ernie_profile_step", lambda: cs.profile_step(torch, step, xx, yy))

    def raw(acts, parse):
        with profile(activities=acts) as prof:
            for _ in range(cs.PROFILE_PAD):
                torch.cuda._sleep(1)
            for _ in range(2):
                step(xx, yy)
            torch.cuda.synchronize()
        return len(prof.events()) if parse else None

    both = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out["events_cpu_cuda"] = timed("raw_cpu_cuda_parse",
                                   lambda: raw(both, True))
    timed("raw_cpu_cuda_noparse", lambda: raw(both, False))
    out["events_cuda"] = timed("raw_cuda_parse",
                               lambda: raw([ProfilerActivity.CUDA], True))
    step.release()
    del step, model
    torch.cuda.empty_cache()

    gm = cs._gpt_model(pt, "cuda")
    st = generate_programs(gm)
    rng = np.random.RandomState(0)
    for tag, (b, p, n) in (("gen", cs.GEN_SHAPE),
                           ("gen64", cs.GEN_CAPTURE_SHAPE)):
        ids = torch.from_numpy(rng.randint(0, cs.GPT2["vocab_size"],
                                           (b, p))).cuda()
        kw = dict(max_new_tokens=n, seed=cs.GEN_SEED, dtype="bfloat16")
        timed(f"{tag}_first", lambda: gm.generate(ids, **kw))
        timed(f"{tag}_second", lambda: gm.generate(ids, **kw))
        timed(f"{tag}_eager", lambda: gm.generate(ids, eager=True, **kw))
        timed(f"{tag}_profile_call", lambda: cs.device_profile(
            torch, lambda: gm.generate(ids, **kw), runs=1))
        prog = st.last
        timed(f"{tag}_profile_prefill", lambda: cs.device_profile(
            torch, prog.graphs["prefill"].replay, runs=3))
        timed(f"{tag}_profile_finish", lambda: cs.device_profile(
            torch, prog.graphs["finish"].replay, runs=3))
        if tag == "gen":
            kw32 = dict(kw, dtype=None)
            timed("gen32_first", lambda: gm.generate(ids, **kw32))
            timed("gen32_eager", lambda: gm.generate(ids, eager=True,
                                                     **kw32))
    st.release()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
