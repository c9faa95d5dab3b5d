"""Report the three-way comparisons of the BatchNorm parity tests.

Runs the five tests whose asserts fall back to torch_vision_weights
nearer_f64 where the port and the JAX package part by more than a
tolerance, and prints, test by test, how many values fell back and the
largest of each distance nearer_f64 measured: the port's (or the JAX
mesh step's) f32 value from the reference f32 value (vs_ref), from the
float64 step (got_vs_f64), and the reference's from the float64 step
(ref_vs_f64). Each value's verdict counts in the tests' own pass/fail.

    JAX_PLATFORMS=cpu python tests/bn_rounding_report.py
"""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

TESTS = [
    "test_torch_resnet_train.py::test_resnet18_trainstep_matches_jax",
    "test_torch_resnet_train.py::test_grad_accum_keeps_last_microbatch_update",
    "test_torch_resnet_train.py::test_remat_updates_running_stats_once",
    "test_torch_yolo.py::test_three_adam_steps_match_the_jax_train_step",
    "test_torch_bn_parallel.py::"
    "test_jax_dp_step_normalises_over_the_global_batch",
]


class Recorder:
    """Wraps nearer_f64 (after tests/conftest.py has set JAX up, before
    the test modules import it) and files each comparison under the
    running test."""

    def __init__(self):
        self.seen, self.test = {}, None

    def pytest_sessionstart(self, session):
        import torch_vision_weights
        inner = torch_vision_weights.nearer_f64

        def nearer_f64(got, ref, want64):
            ok, seen = inner(got, ref, want64)
            self.seen.setdefault(self.test, []).append((ok, seen))
            return ok, seen
        torch_vision_weights.nearer_f64 = nearer_f64

    def pytest_runtest_setup(self, item):
        self.test = item.nodeid


def main():
    rec = Recorder()
    rc = pytest.main(["-q", "-p", "no:cacheprovider"]
                     + [os.path.join(HERE, t) for t in TESTS], plugins=[rec])
    for t in TESTS:
        rows = next((v for k, v in rec.seen.items() if k.endswith(t)), [])
        line = f"{t}: {len(rows)} values held three ways"
        if rows:
            worst = {k: max(s[k] for _, s in rows)
                     for k in ("vs_ref", "got_vs_f64", "ref_vs_f64")}
            line += (f", all ok {all(ok for ok, _ in rows)}, max "
                     + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        print(line)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
