"""chip_smoke.py's arithmetic, without a card.

chip_smoke.py needs only the standard library at import (torch is
imported inside main()), so its bound and SASS-reading helpers run
here: the forward's bytes and flops at the training shape, the Philox
work counted with dropout and absent without it, the keep-bit loop found
in a SASS listing, and the ptxas serialisation lines named; and the
gates of the generate_capture and telemetry phases, each failure named.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the training path's attention: b 48, s 512, n 12, h 64, bf16
B, S, N, H = 48, 512, 12, 64


def test_import_needs_only_the_standard_library():
    code = ("import importlib.util, sys; "
            f"spec = importlib.util.spec_from_file_location('c', "
            f"{str(ROOT / 'chip_smoke.py')!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); "
            "bad = [k for k in ('torch', 'numpy', 'jax') "
            "if k in sys.modules]; sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code]).returncode == 0


def test_forward_bound_at_the_training_shape(cs):
    """q, k, v read and O written once in bf16, lse in f32; QK^T and PV
    over every link: bound by bytes, 0.045 ms at 3.35 TB/s."""
    row = cs.fwd_bound(B, S, S, N, H, False, "bfloat16")
    el = B * S * N * H
    assert row["bytes"] == 4 * el * 2 + B * N * S * 4 == 152_174_592
    assert row["flops"] == 4 * B * N * H * S * S == 38_654_705_664
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(152_174_592 / 3.35e12 * 1e3)


@pytest.mark.parametrize("p", [0.0, 0.1])
def test_forward_bound_counts_the_philox_work_only_with_dropout(cs, p):
    """At p 0.1 one Philox4x32-10 call per 2x2 block of links, and with
    the card's numbers (instructions per call, SMs, clock) the floor of
    their integer work, which the byte bound cannot reach; at p 0 no
    such work is counted."""
    ipc, sms, mhz = 47.25, 132, 1980.0
    row = cs.fwd_bound(B, S, S, N, H, False, "bfloat16", p, (ipc, sms, mhz))
    base = cs.fwd_bound(B, S, S, N, H, False, "bfloat16")
    assert (row["bytes"], row["flops"], row["bound_ms"]) == \
        (base["bytes"], base["flops"], base["bound_ms"])
    if not p:
        assert row["philox_calls"] is None
        assert row["philox_floor_ms"] is None
        assert "no dropout work" in row["bound_note"]
        return
    calls = B * N * S * S // 4
    assert row["philox_calls"] == calls == 37_748_736
    assert row["philox_int_instructions"] == calls * ipc
    floor = calls * ipc / (sms * 64 * mhz * 1e6) * 1e3
    assert row["philox_floor_ms"] == pytest.approx(floor)
    assert row["bound_reachable"] is False
    assert "leaves out" in row["bound_note"]


def test_causal_bound_counts_the_kept_links(cs):
    row = cs.fwd_bound(2, 8, 8, 1, 64, True, "bfloat16", 0.1)
    assert row["flops"] == 4 * 2 * 64 * (8 * 9 // 2)
    assert row["philox_calls"] == 2 * (8 * 9 // 2) // 4
    assert row["philox_floor_ms"] is None      # no card numbers given


def _sass(calls_inner, outer=True):
    """A cuobjdump -sass listing: a keep-bit loop of `calls_inner`
    Philox calls (20 multiplies and 4 threshold compares each), inside
    an outer loop."""
    lines = ["\t\tFunction : _Z9fwd_wgmmaILi64ELb0ELb1EEEv"]
    addr = 0

    def ins(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     "   /* 0x000fe20000000f00 */")
        addr += 16
    ins("MOV R1, c[0x0][0x28]")
    top = addr
    ins("SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4+0x19040], R5")
    loop = addr
    for _ in range(calls_inner):
        for r in range(10):
            ins("IMAD.WIDE.U32 R6, R6, -0x2daee0ad, RZ")
            ins("IMAD.WIDE.U32 R4, R4, -0x326172a9, RZ")
            ins("LOP3.LUT R40, R7, UR35, R4, 0x96, !PT")
            ins("LOP3.LUT R36, R5, UR36, R6, 0x96, !PT")
        for _ in range(4):
            ins("ISETP.GE.U32.AND P4, PT, R22, UR8, PT")
    ins("ISETP.NE.AND P0, PT, R41, 0x24, PT")
    ins(f"@P0 BRA 0x{loop:x}")
    if outer:
        ins("STS [R4], R38")
        ins(f"@!P0 BRA 0x{top:x}")
    ins("EXIT")
    return "\n".join(lines)


def test_philox_loop_is_the_innermost_loop_with_the_rounds(cs):
    funcs = cs.sass_functions(_sass(4))
    (name, instrs), = funcs.items()
    assert "fwd_wgmma" in name
    body = 4 * (10 * 4 + 4) + 2
    assert cs.philox_loop(instrs) == (body / 4, 4, body)


def test_philox_loop_is_none_without_philox(cs):
    funcs = cs.sass_functions(_sass(0))
    (instrs,) = funcs.values()
    assert cs.philox_loop(instrs) is None


def test_ptxas_serialisation_lines_name_the_function(cs):
    log = "\n".join([
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized due to the presence of Extern "
        "calls in the function '_Z9fwd_wgmmaILi64ELb0ELb0EEEv'",
        "ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async"
        " instructions are serialized due to insufficient register "
        "resources for the function '_Z9dkv_wgmmaILi128ELb0ELb0EEEv'",
        "ptxas info    : Used 168 registers, used 1 barriers",
    ])
    assert cs.ptxas_serialised(log) == ["_Z9fwd_wgmmaILi64ELb0ELb0EEEv",
                                        "_Z9dkv_wgmmaILi128ELb0ELb0EEEv"]
    assert "fwd_wgmma" in cs.NO_SPILL


def test_streams_agree_applies_the_near_tie_rule(cs):
    """A stream passes when it equals its reference, or when it first
    differs where the reference's top-2 logit gap is below NEAR_TIE;
    any other difference, or a shorter stream, fails."""
    import numpy as np
    want = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [1, 2, 3]]
    got = [[1, 2, 3], [4, 9, 9], [7, 1, 9], [1, 2]]
    gaps = [np.full(3, 0.5), np.array([0.5, cs.NEAR_TIE / 2, 0.5]),
            np.full(3, 0.5), np.full(3, 0.5)]
    rows = cs.streams_agree(got, want, gaps)
    assert rows[0] == {"equal": True, "first_mismatch": None, "ok": True}
    assert rows[1]["first_mismatch"] == 1 and rows[1]["near_tie"]
    assert rows[1]["ok"] and not rows[1]["equal"]
    assert rows[2]["first_mismatch"] == 1 and not rows[2]["ok"]
    assert rows[3]["first_mismatch"] == 2 and not rows[3]["ok"]


def test_rel_gap_is_the_top2_gap_over_the_top(cs):
    import numpy as np
    import torch
    lg = torch.tensor([[1.0, 3.0, 2.0], [-2.0, -1.0, -1.0]])
    np.testing.assert_allclose(cs._rel_gap(lg), [1 / 3, 0.0])


def test_int8_acc_plain_is_the_exact_int32_accumulator(cs):
    """The float64 plain version of int8_gemm equals torch._int_mm's
    int32 accumulator at GPT-2 small's widest contraction (K 3072),
    extreme codes included (|acc| up to 128 * 128 * 3072, past f32's
    24-bit significand), and refuses a K past float64's exact range."""
    import torch
    g = torch.Generator().manual_seed(0)
    codes = torch.randint(-128, 128, (5, 3072), generator=g,
                          dtype=torch.int8)
    q8 = torch.randint(-128, 128, (768, 3072), generator=g,
                       dtype=torch.int8).t()
    codes[0] = -128
    q8[:, 0] = -128
    want = torch._int_mm(codes, q8)
    got = cs.int8_acc_plain(torch, codes, q8)
    assert got.dtype == torch.float64
    assert torch.equal(got, want.double())
    assert got[0, 0].item() == 128 * 128 * 3072
    huge = torch.zeros((1, 1), dtype=torch.int8).expand(1, 2 ** 39)
    with pytest.raises(ValueError, match="exactly"):
        cs.int8_acc_plain(torch, huge, huge.t())


def test_int8_bound_at_the_fc2_shape(cs):
    """x [128, 3072] bf16 and q8 [3072, 768] int8 read once, the scales
    and the bf16 output written once; 2 m k n int8 operations at 1979
    TOP/s: bound by bytes."""
    nbytes, ops, bound_ms, by = cs.int8_bound(128, 3072, 768)
    assert nbytes == 128 * 3072 * 2 + 3072 * 768 + 768 * 4 + 128 * 768 * 2
    assert ops == 2 * 128 * 3072 * 768
    assert by == "bytes"
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert cs.PEAK_FLOPS["int8"] == 1979e12


def test_shared_prefix_trace_is_the_loadgen_shape(cs):
    """One trace-wide prefix of SHARED_PREFIX tokens on about
    SHARED_FRAC of the requests, tails and new tokens in their ranges,
    every request within the serving config; the same seed gives the
    same trace, frac 0 gives no prefix."""
    import numpy as np
    prompts, news, hit = cs.shared_prefix_trace(np, 200, 50304)
    again = cs.shared_prefix_trace(np, 200, 50304)
    assert all(np.array_equal(a, b) for a, b in zip(prompts, again[0]))
    assert news == again[1] and hit == again[2]
    head = next(p for p, h in zip(prompts, hit) if h)[:cs.SHARED_PREFIX]
    lo, hi = cs.SHARED_TAILS
    for p, n, h in zip(prompts, news, hit):
        tail = p[cs.SHARED_PREFIX:] if h else p
        assert lo <= tail.size <= hi and p.dtype == np.int32
        if h:
            assert np.array_equal(p[:cs.SHARED_PREFIX], head)
        assert cs.SHARED_NEW[0] <= n <= cs.SHARED_NEW[1]
        assert p.size <= max(cs.SERVE_CONFIG["prefill_buckets"])
        assert p.size + n <= cs.SERVE_CONFIG["max_total_tokens"]
    assert 0.85 <= np.mean(hit) <= 0.95
    _, _, none = cs.shared_prefix_trace(np, 50, 50304, frac=0.0)
    assert not any(none)


# GPT-2 small's training attention: b 8, s 1024, n 12, h 64, causal
GB, GS = 8, 1024


def test_gpt_train_forward_bound_and_philox_floor(cs):
    """Causal, p 0.1: s (s + 1) / 2 kept links a head, one Philox call
    per 2x2 block of them (12,595,200 calls); bound by bytes at 0.0151
    ms, while 47.25 instructions a call at 64 integer ops per clock on
    132 SMs at 1980 MHz set a floor of about 0.036 ms."""
    ipc, sms, mhz = 47.25, 132, 1980.0
    row = cs.fwd_bound(GB, GS, GS, N, H, True, "bfloat16", 0.1,
                       (ipc, sms, mhz))
    links = GS * (GS + 1) // 2
    assert row["flops"] == 4 * GB * N * H * links
    assert row["bytes"] == 4 * GB * GS * N * H * 2 + GB * N * GS * 4
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(0.0151, abs=5e-5)
    assert row["philox_calls"] == GB * N * links // 4 == 12_595_200
    assert row["philox_floor_ms"] == pytest.approx(
        12_595_200 * ipc / (sms * 64 * mhz * 1e6) * 1e3)
    assert row["philox_floor_ms"] == pytest.approx(0.0356, abs=5e-4)
    assert row["bound_reachable"] is False


def test_gpt_train_backward_bounds(cs):
    """dQ: 3 products over the causal links, dK/dV: 4; bytes as the
    training shape counts them (each input read once, each output
    written once)."""
    links = GS * (GS + 1) // 2
    el = GB * GS * N * H
    for kern, products, nbytes in (("dq", 3, 6 * el * 2),
                                   ("dkv", 4, 6 * el * 2)):
        ms, by = cs.bwd_bound_ms(kern, GB, GS, GS, N, H, True, "bfloat16")
        flops = products * 2.0 * GB * N * H * links
        stats = 2 * GB * N * GS * 4
        want = max((nbytes + stats) / 3.35e12, flops / 989e12) * 1e3
        assert ms == pytest.approx(want)


def test_gpt2_small_params_and_flops_per_token(cs):
    """N = 124,475,904 for GPT-2 small (vocab 50304, 1024 positions, 12
    layers of 768): 860.1 MFLOP a token by bench.py's 6N + 12 L h s."""
    n = cs.gpt_param_count(**cs.GPT_TRAIN)
    assert n == 124_475_904
    f = cs.train_flops_per_token(n, 12, 768, 1024)
    assert f == 6 * 124_475_904 + 12 * 12 * 768 * 1024 == 860_101_632
    assert cs.GPT_TRAIN["dropout"] == 0.1
    assert cs.GPT_TRAIN_BATCH == (8, 1024)


@pytest.mark.parametrize("n,vocab,blocks,padded,logits_gb", [
    (48 * 512, 30528, 15, 30720, 1.50),    # ERNIE-base MLM head, 48x512
    (8 * 1023, 50304, 25, 51200, 0.82)])   # GPT-2 small LM head, 8x1024
def test_chunked_head_padding_and_work(cs, n, vocab, blocks, padded,
                                       logits_gb):
    """The vocab padded to a multiple of the 2048-column block; 4 f32
    GEMMs a block of 2 n d flops a column (ERNIE 4.6 TFLOP a step, GPT
    2.6), bound by the f32 pipes; the bf16 logits it never builds."""
    w = cs.chunked_head_work(n, 768, vocab, 2048)
    assert (w["blocks"], w["padded_vocab"], w["pad"]) == \
        (blocks, padded, padded - vocab)
    assert w["flops"] == 4 * 2.0 * n * 768 * padded
    assert w["bound_by"] == "operations"
    assert w["bound_ms"] == pytest.approx(w["flops"] / 67e12 * 1e3)
    assert w["logits_bf16_bytes"] / 1e9 == pytest.approx(logits_gb,
                                                         abs=0.005)
    assert w["flops"] / 1e12 == pytest.approx(
        {30528: 4.64, 50304: 2.58}[vocab], abs=0.01)


def _causal_like(seed=0, s=1024, h=64):
    """An O-like [s, h] tensor: row i about 1/sqrt(i + 1) in size, as a
    causal attention output over random values."""
    import torch
    g = torch.Generator().manual_seed(seed)
    rows = torch.arange(s, dtype=torch.float32)[:, None]
    return torch.randn((s, h), generator=g) / torch.sqrt(rows + 1.0)


def test_row_check_catches_late_rows_the_global_check_passes(cs):
    """A 30% error in the rows past 300 stays inside 2e-2 x max|ref|
    (the rows there hold about 1/17 of row 0), but not inside 2e-2 of
    each row's own max|ref|."""
    ref = _causal_like()
    bad = ref.clone()
    bad[300:] *= 1.3
    assert cs._err_ok(bad, ref, "bfloat16")[2]
    err, ratio, ok = cs._row_err_ok(bad, ref, "bfloat16")
    assert not ok and ratio == pytest.approx(0.3, rel=1e-4)


def test_row_check_passes_bf16_rounding_and_cancelled_rows(cs):
    """bf16 rounding of every element passes row by row; a row that
    cancels to noise (dQ of causal row 0) is held to the floor, not to
    its own size."""
    import torch
    ref = _causal_like(seed=1)
    ref[0] = 1e-7
    got = ref.to(torch.bfloat16).float()
    got[0] = -1e-6
    err, ratio, ok = cs._row_err_ok(got, ref, "bfloat16")
    assert ok and ratio <= 2 ** -8
    # f32: each row against max(1, its max|ref|), so an error of 2e-4 in
    # a row below 1 fails where it would in the whole-tensor check too
    off = ref.clone()
    off[700, 3] += 2e-4
    assert not cs._row_err_ok(off, ref, "float32")[2]
    assert cs._row_err_ok(ref.clone(), ref, "float32")[2]


def test_launch_sums_and_expectations(cs, monkeypatch):
    """A captured run's launches are the sum of its counted calls (the
    warm-up's wrapper count, the replays' count on the card); every call
    must launch the forward once per layer (twice under remat: its
    recompute) and each backward kernel once per layer."""
    one = {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12,
           "flash_attn_bwd_dkv": 12}
    remat = dict(one, flash_attn_fwd=24)
    assert cs._sum_launches([one, one, one]) == {k: 36 for k in one}
    assert cs._sum_launches([]) == {}
    failed = []
    monkeypatch.setattr(cs, "fail", failed.append)
    cs._expect_launches("gpt", [one, one], 12)
    cs._expect_launches("gpt remat", [remat], 12, fwd=2)
    assert failed == []
    cs._expect_launches("gpt", [one, remat], 12)
    cs._expect_launches("gpt remat", [one], 12, fwd=2)
    assert len(failed) == 2 and "step 1" in failed[0]


def test_bit_equal_and_max_abs_diff(cs):
    import torch
    a = [torch.tensor([1.0, 2.0]), torch.tensor([[0.5]])]
    b = [t.clone() for t in a]
    assert cs._bit_equal(a, b) and cs._max_abs_diff(a, b) == 0.0
    b[1] = torch.tensor([[0.25]])
    assert not cs._bit_equal(a, b)
    assert cs._max_abs_diff(a, b) == 0.25
    assert cs._rel_diff(3.0, 2.0) == 0.5


def test_kernel_launches_count_device_events_by_wrapper(cs):
    """Profiler event names map to the wrapper whose kernel they are
    (bf16 wgmma and f32 simt); library kernels count for none."""
    names = ["void fwd_wgmma<64, true, true>(CUtensorMap_st, FwdArgs)",
             "void dq_wgmma<64, true, true>(CUtensorMap_st, BwdArgs)",
             "void dkv_wgmma<64, true, true>(CUtensorMap_st, BwdArgs)",
             "void flash_fwd_simt<64, false, false>(float const*)",
             "void dq_simt<64, false, false>(BwdArgs)",
             "void dkv_simt<64, false, false>(BwdArgs)",
             "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT",
             "void at::native::vectorized_elementwise_kernel<4>()",
             "void fwd_wgmma<64, true, true>(CUtensorMap_st, FwdArgs)"]
    assert cs.kernel_launches(names) == {
        "flash_attn_fwd": 3, "flash_attn_bwd_dq": 2,
        "flash_attn_bwd_dkv": 2}
    assert cs.kernel_launches([]) == {k: 0 for k in cs.KERNEL_EVENTS}


def test_per_call_keeps_a_remainder_visible(cs, monkeypatch):
    """Launches over two replays become launches a replay; a count that
    does not divide (a lost or doubled node in one replay) stays a
    fraction and fails the whole expectation."""
    assert cs.per_call({"flash_attn_fwd": 24, "flash_attn_bwd_dq": 24},
                       2) == {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12}
    odd = cs.per_call({"flash_attn_fwd": 23, "flash_attn_bwd_dq": 24,
                       "flash_attn_bwd_dkv": 24}, 2)
    assert odd["flash_attn_fwd"] == 11.5
    failed = []
    monkeypatch.setattr(cs, "fail", failed.append)
    cs._expect_launches("gpt", [odd], 12)
    assert len(failed) == 1


def test_max_counts_survives_a_dropped_record(cs):
    """A record the profiler dropped lowers one round's count only; a
    kernel node missing from the graph lowers every round's."""
    full = {"flash_attn_fwd": 24, "flash_attn_bwd_dq": 24,
            "flash_attn_bwd_dkv": 24}
    dropped = dict(full, flash_attn_fwd=23)
    assert cs.max_counts([dropped, full, full]) == full
    assert cs.max_counts([full, full, dropped]) == full
    lost = dict(full, flash_attn_bwd_dq=22)
    assert cs.max_counts([lost, lost, lost]) == lost


def _gen_row(**kw):
    row = dict(mode="greedy", dtype="bfloat16", bit_equal=True,
               second_call_captures=0, sentinel_events=0, graphs=3,
               expected_graphs=3)
    row.update(kw)
    return row


@pytest.mark.parametrize("bad,word", [
    (dict(bit_equal=False), "differ from eager"),
    (dict(second_call_captures=2), "captured 2 programs"),
    (dict(sentinel_events=1), "1 sentinel events"),
    (dict(graphs=4), "4 programs, expected 3"),
    (dict(sampled=True, other_seed_differs=True), "not held"),
    (dict(sampled=True, other_seed_bit_equal=False,
          other_seed_differs=True), "at the second seed"),
    (dict(sampled=True, other_seed_bit_equal=True,
          other_seed_differs=False), "repeated the first")])
def test_generate_capture_gates_name_each_failure(cs, bad, word):
    sampled = _gen_row(mode="top_k", sampled=True, other_seed_bit_equal=True,
                       other_seed_differs=True)
    assert cs.generate_capture_gates([_gen_row(), _gen_row(mode="beam"),
                                      sampled]) == []
    out = cs.generate_capture_gates([_gen_row(), _gen_row(**bad)])
    assert len(out) == 1 and word in out[0] and "greedy" in out[0]


def _telemetry_row():
    counters = dict(tokens_total=2929, retired_total=48, admitted_total=48,
                    ttft_count=48)
    return dict(requests=48, tokens_emitted=2977, streams_equal=True,
                counters=counters, requests_missing_spans=[],
                tail_component="decode",
                pulse_metrics={k: counters[k] for k in cs_pulse()},
                oom=dict(propagated=True, oom_total=1, receipt="oom.json",
                         receipt_free_bytes=82_044_612_771,
                         mem_get_info_free=82_040_782_848),
                train_step=dict(calls=4, step_begin=4, step_end=4,
                                steps=[0, 1, 2, 3]))


def cs_pulse():
    return ("tokens_total", "retired_total", "admitted_total")


def _set(row, path, value):
    *head, last = path
    for k in head:
        row = row[k]
    row[last] = value


@pytest.mark.parametrize("path,value,word", [
    (("streams_equal",), False, "streams changed"),
    (("counters", "retired_total"), 47, "retired 47"),
    (("counters", "ttft_count"), 40, "ttft count 40"),
    (("counters", "tokens_total"), 2977, "tokens emitted"),
    (("requests_missing_spans",), [5], "without their spans"),
    (("tail_component",), None, "named no component"),
    (("pulse_metrics", "tokens_total"), 0, "/metrics served"),
    (("oom", "propagated"), False, "OOM sentry"),
    (("oom", "oom_total"), 0, "OOM sentry"),
    (("oom", "receipt"), None, "OOM sentry"),
    (("oom", "receipt_free_bytes"), 70_000_000_000, "more than 5% off"),
    (("train_step", "step_end"), 3, "TrainStep"),
    (("train_step", "steps"), [0, 1, 1, 3], "TrainStep")])
def test_telemetry_gates_name_each_failure(cs, path, value, word):
    assert tuple(cs.PULSE_COUNTERS) == cs_pulse()
    assert cs.telemetry_gates(_telemetry_row()) == []
    row = _telemetry_row()
    _set(row, path, value)
    if path[0] == "counters" and path[1] in row["pulse_metrics"]:
        # /metrics serves what the registry holds
        row["pulse_metrics"][path[1]] = value
    out = cs.telemetry_gates(row)
    assert len(out) == 1 and word in out[0], out


def _elastic_inc(inc, losses, resume=None, cands=(), done=True):
    want = {k: 12 for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                            "flash_attn_bwd_dkv")}
    return dict(incarnation=inc, resume_step=resume, restore_ms=1.0,
                candidate_steps=list(cands), done=done, graphs=1,
                captures=1, replays=3, sentinel_events=0,
                warmup_launches=want, losses=losses, saves=[],
                goodput={"checkpoint_fraction": 0.1})


def _elastic_runs():
    ctrl = {str(s): 5.0 - 0.1 * s for s in range(8)}
    man = {"['train']['w']": {"crc32": 1}, "['train']['m']": {"crc32": 2}}
    control = dict(name="control", mode=None, at=None, seconds=1.0,
                   incs=[_elastic_inc(0, dict(ctrl))], receipts=[],
                   progress=[], manifest=dict(man))
    first = {str(s): ctrl[str(s)] for s in range(5)}
    second = {str(s): ctrl[str(s)] for s in range(4, 8)}
    kill = dict(name="kill", mode="kill", at=5, seconds=2.0,
                incs=[_elastic_inc(0, first, done=False),
                      _elastic_inc(1, second, resume=3, cands=(3, 1))],
                receipts=[{"action": "respawn_gang", "backoff_s": 0.1,
                           "verdict": {"kind": "crash", "rank": 0}}],
                progress=[{"inc": 0, "step": 5, "phase": "begin",
                           "t": 10.0},
                          {"inc": 1, "step": 4, "phase": "end",
                           "t": 25.0}],
                manifest=dict(man))
    return control, kill


@pytest.mark.parametrize("breakage,word", [
    (None, None),
    ("loss", "against the control's"),
    ("manifest", "final manifest differs"),
    ("resume", "resumed from"),
    ("receipts", "receipts"),
    ("launches", "warm-up launches"),
    ("unfinished", "incarnations")])
def test_elastic_gates_name_each_failure(cs, breakage, word):
    control, kill = _elastic_runs()
    if breakage == "loss":
        kill["incs"][1]["losses"]["6"] += 1e-7
    elif breakage == "manifest":
        kill["manifest"]["['train']['m']"] = {"crc32": 3}
    elif breakage == "resume":
        kill["incs"][1]["candidate_steps"] = [5, 3]
    elif breakage == "receipts":
        kill["receipts"] = kill["receipts"] * 2
    elif breakage == "launches":
        kill["incs"][0]["warmup_launches"]["flash_attn_bwd_dq"] = 11
    elif breakage == "unfinished":
        kill["incs"][1]["done"] = False
    assert cs._elastic_row(control, None)[1] == []
    row, bad = cs._elastic_row(kill, control)
    if breakage is None:
        assert bad == []
        assert row["resume_step"] == 3 and row["died_at_step"] == 5
        assert row["kill_to_first_resumed_step_s"] == 15.0
        assert row["manifest_leaves_equal"] == 2
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_fleet_ladder_covers_every_resumable_prefix(cs):
    """The fleet's config adds the 256 bucket: requeue needs a prefill
    bucket for max_total_tokens - 1 tokens, which SERVE_CONFIG's ladder
    lacks."""
    assert cs.SERVE_CONFIG["prefill_buckets"][-1] < \
        cs.SERVE_CONFIG["max_total_tokens"] - 1
    assert cs.FLEET_CONFIG["prefill_buckets"][-1] >= \
        cs.FLEET_CONFIG["max_total_tokens"] - 1
    assert {k: v for k, v in cs.FLEET_CONFIG.items()
            if k != "prefill_buckets"} == {
        k: v for k, v in cs.SERVE_CONFIG.items() if k != "prefill_buckets"}


def test_nccl_events_are_told_from_the_rest(cs):
    """dp_train counts NCCL's kernels in a replay's profile: the
    collective kernels of several ranks, and at one rank oneRankReduce
    (an AVG all-reduce scaling by 1/1), whose mangled name the profiler
    shows on the H100 (PERF.md §6)."""
    one_rank = ("__nv_static_32__b4148644_10_onerank_cu_fdf47990__ZN43_"
                "GLOBAL__N__b4148644_10_onerank_cu_fdf4799013oneRankReduceI"
                "13FuncPreMulSumIfEEEvPvS3_mmb")
    for name in (one_rank, "ncclDevKernel_AllReduce_Sum_f32_RING_LL",
                 "nccl:all_reduce"):
        assert cs.is_nccl(name), name
    for name in ("void at::native::vectorized_elementwise_kernel<4>",
                 "fwd_wgmma<64>", "Memcpy DtoD (Device -> Device)"):
        assert not cs.is_nccl(name), name


def test_loadgen_trace_is_serving_bench_default_and_fits_the_ladders(cs):
    """The loadgen phase replays tools/serving_bench.py's default trace
    (40 requests, seed 0, 60/s): every prompt fits the engine's ladder
    and every request the fleet's requeue ladder."""
    assert cs.LOADGEN_TRACE == dict(n_requests=40, seed=0, rate_rps=60.0)
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.serving import loadgen
    trace = loadgen.synthetic_trace(vocab_size=cs.GPT2["vocab_size"],
                                    **cs.LOADGEN_TRACE)
    longest = max(it.ids.size + it.max_new_tokens for it in trace)
    assert max(it.ids.size for it in trace) <= \
        max(cs.SERVE_CONFIG["prefill_buckets"])
    assert longest <= cs.SERVE_CONFIG["max_total_tokens"]
    assert max(cs.FLEET_CONFIG["prefill_buckets"]) >= \
        cs.FLEET_CONFIG["max_total_tokens"] - 1


# -- the planner phases (moe_train, plan_train, sp_train) ----------------------

def _launches(n):
    return {"flash_attn_fwd": n, "flash_attn_bwd_dq": n,
            "flash_attn_bwd_dkv": n}


def _moe_row():
    return dict(graphs=1, sentinel_events=0, max_loss_rel_diff=0.0,
                params_bit_equal=True, layers=12,
                nccl_launches_per_replay=243, nccl_expected=243,
                launches_per_replay=_launches(12), card_vs_cpu_ok=True,
                dropped_share={"layer1": 0.0, "layer3": 0.375})


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("graphs", "graphs"), ("loss", "bit-equal"),
    ("params", "bit-equal"), ("launches", "launched"),
    ("cpu", "the CPU"), ("dropped", "dropped shares"),
    ("nccl", "NCCL kernels")])
def test_moe_train_gates_name_each_failure(cs, breakage, word):
    row = _moe_row()
    if breakage == "graphs":
        row["graphs"] = 2
    elif breakage == "loss":
        row["max_loss_rel_diff"] = 1e-7
    elif breakage == "params":
        row["params_bit_equal"] = False
    elif breakage == "launches":
        row["launches_per_replay"] = dict(_launches(12), flash_attn_fwd=11)
    elif breakage == "cpu":
        row["card_vs_cpu_ok"] = False
    elif breakage == "dropped":
        row["dropped_share"]["layer5"] = 1.0
    elif breakage == "nccl":
        row["nccl_launches_per_replay"] = 242.5
    bad = cs.moe_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


@pytest.mark.parametrize("breakage", [None, "loss", "params", "graphs"])
def test_plan_train_gates_name_each_failure(cs, breakage):
    run = dict(losses_bit_equal=True, params_bit_equal=True, graphs=1,
               sentinel_events=0)
    runs = {k: dict(run) for k in ("meshplan_dp1", "zero1", "zero2",
                                   "zero3")}
    if breakage == "loss":
        runs["zero2"]["losses_bit_equal"] = False
    elif breakage == "params":
        runs["zero3"]["params_bit_equal"] = False
    elif breakage == "graphs":
        runs["zero1"]["graphs"] = 2
    bad = cs.plan_train_gates({"runs": runs})
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1, bad


def _sp_row():
    mode = dict(graphs=1, sentinel_events=0)
    return dict(layers=12,
                ulysses=dict(mode, losses_bit_equal=True,
                             params_bit_equal=True,
                             launches_per_step=_launches(12),
                             warmup_launches=_launches(12)),
                ring=dict(mode, launches_per_step=_launches(0),
                          warmup_launches=_launches(0), loss_ok=True,
                          params_ok=True, max_loss_rel_diff=3e-6,
                          params_max_abs_diff=1e-4, params_tol=2e-2))


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("ulysses_bits", "bit-equal"),
    ("ulysses_launches", "Ulysses launched"),
    ("ring_launches", "ring launched"), ("ring_loss", "bf16 gate"),
    ("graphs", "graphs")])
def test_sp_train_gates_name_each_failure(cs, breakage, word):
    row = _sp_row()
    if breakage == "ulysses_bits":
        row["ulysses"]["params_bit_equal"] = False
    elif breakage == "ulysses_launches":
        row["ulysses"]["warmup_launches"] = _launches(11)
    elif breakage == "ring_launches":
        row["ring"]["launches_per_step"] = _launches(12)
    elif breakage == "ring_loss":
        row["ring"]["loss_ok"] = False
    elif breakage == "graphs":
        row["ring"]["graphs"] = 2
    bad = cs.sp_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_ernie_param_count_is_the_models(cs):
    """plan_train's ModelDims count ERNIE's parameters in closed form,
    equal to the port's ErnieForPretraining's count; moe_train's MFU
    counts the active ones (a token idles E - k of each MoE layer's E
    experts)."""
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
    cfg = dict(vocab_size=96, hidden_size=16, num_hidden_layers=3,
               num_attention_heads=2, intermediate_size=24,
               max_position_embeddings=20)
    m = ErnieForPretraining(ErnieConfig(**cfg), device="cpu")
    assert cs.ernie_param_count(96, 16, 3, 24, 20) == \
        sum(p.numel() for p in m.parameters())
    mm = ErnieForPretraining(ErnieConfig(**cfg, moe_num_experts=4),
                             device="cpu")
    # one MoE layer (the 2nd): top-2 of 4 experts, half idle a token
    moe = mm.ernie.encoder[1].moe
    skipped = sum(t.numel() for t in (moe.w1, moe.b1, moe.w2, moe.b2)) // 2
    assert cs.active_params(mm) == \
        sum(p.numel() for p in mm.parameters()) - skipped


def test_pipe_expected_counts_the_ernie_base_step(cs):
    """4 stages x 8 microbatches of 12 blocks: 168 forwards (96 in F, 72
    again in the non-last stages' B), 96 of each backward kernel, 60
    dispatches, 15 graphs, held inputs min(M, S - s)."""
    want = cs.pipe_expected(4, 8)
    assert want["launches"] == {"flash_attn_fwd": 168,
                                "flash_attn_bwd_dq": 96,
                                "flash_attn_bwd_dkv": 96}
    assert want["dispatches"] == 60 and want["graphs"] == 15
    assert want["in_flight"] == [4, 3, 2, 1]
    # one microbatch: no accumulating B or L graph
    assert cs.pipe_expected(2, 1, L=2)["graphs"] == 2 + 1 + 2


def test_stage_state_carries_ernie_into_the_stages(cs):
    """stage_state cuts ErnieForPretraining's weights into the stages
    (the decoder untied: the word embeddings transposed, the MLM bias):
    at dropout 0 the chained stages compute the tied model's outputs."""
    sys.path.insert(0, str(ROOT))
    import torch
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         ernie_pipeline_stages)
    cfg = ErnieConfig(vocab_size=96, hidden_size=16, num_hidden_layers=5,
                      num_attention_heads=2, intermediate_size=24,
                      max_position_embeddings=20, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    m = ErnieForPretraining(cfg, device="cpu").eval()
    with torch.no_grad():
        m.mlm_bias.normal_()
    stages = ernie_pipeline_stages(cfg, 3, device="cpu")
    for st, sd in zip(stages, cs.stage_state(m.state_dict(), 3)):
        missing, extra = st.set_state_dict(sd)
        assert not missing and not extra
        st.eval()
    ids = torch.randint(0, 96, (2, 7))
    with torch.no_grad():
        want = m(ids)
        got = stages[2](stages[1](stages[0](ids)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_untied_plain_is_the_stages_function(cs):
    """_untied_plain (ErnieForPretraining with a decoder of its own)
    takes every weight stage_state gives the stages and computes the
    tied model's outputs there; after an SGD step its parameters match
    the chained stages' (the same function, unsplit)."""
    sys.path.insert(0, str(ROOT))
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                         ernie_pipeline_stages)
    cfg = ErnieConfig(vocab_size=96, hidden_size=16, num_hidden_layers=4,
                      num_attention_heads=2, intermediate_size=24,
                      max_position_embeddings=20, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    m = ErnieForPretraining(cfg, device="cpu")
    with torch.no_grad():
        m.mlm_bias.normal_()
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    plain = cs._untied_plain(pt, cfg, sd, device="cpu")
    stages = ernie_pipeline_stages(cfg, 2, device="cpu")
    for st, ssd in zip(stages, cs.stage_state(sd, 2)):
        st.set_state_dict(ssd)
    ids = torch.randint(0, 96, (2, 7))
    labels = torch.randint(0, 96, (2, 7))
    with torch.no_grad():
        for a, b in zip(plain(ids), m(ids)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for mod, run in ((plain, lambda: plain(ids)),
                     (stages, lambda: stages[1](stages[0](ids)))):
        params = list(plain.parameters()) if mod is plain else \
            [p for st in stages for p in st.parameters()]
        loss = cs._ernie_loss(run(), labels)
        # the NSP head and the pooler take no part in the MLM loss
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            for p, g in zip(params, grads):
                if g is not None:
                    p -= 0.5 * g
    got = plain.state_dict()
    want = cs.stage_state(got, 2)
    # stage_state takes the decoder from the (tied) word embeddings
    want[-1]["decoder.weight"] = got["decoder.weight"]
    for st, ssd in zip(stages, want):
        assert sorted(st.state_dict()) == sorted(ssd)
        for k, v in st.state_dict().items():
            torch.testing.assert_close(v, ssd[k], rtol=1e-5, atol=1e-6,
                                       msg=k)


def _pipe_row():
    want = {"launches": dict(_launches(96), flash_attn_fwd=168),
            "dispatches": 60, "graphs": 15, "in_flight": [4, 3, 2, 1]}
    return dict(expected=want,
                captured_vs_eager=dict(losses_bit_equal=True,
                                       params_bit_equal=True),
                launches_per_step=dict(want["launches"]),
                eager_launches_per_step=dict(want["launches"]),
                routes_per_step={"fwd_wgmma": 168, "flash_fwd_simt": 0},
                path_launches={"flash_attn_fwd": 402,
                               "flash_attn_bwd_dq": 240,
                               "flash_attn_bwd_dkv": 240},
                dispatches=60, graphs=15, captures=15, sentinel_events=0,
                in_flight=[4, 3, 2, 1],
                plain_parity=dict(ok=True, max_rel=1e-7),
                interleaved=dict(losses_ok=True), losses=[10.4, 10.3],
                mfu=0.1)


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("bits", "bit-equal"), ("launches", "launched"),
    ("route", "bf16"), ("path", "no kernel"), ("dispatches", "dispatches"),
    ("graphs", "graphs"), ("sentinel", "sentinel"),
    ("in_flight", "in-flight"), ("parity", "plain step"),
    ("interleaved", "interleaved"), ("loss", "losses")])
def test_pipeline_train_gates_name_each_failure(cs, breakage, word):
    row = _pipe_row()
    if breakage == "bits":
        row["captured_vs_eager"]["params_bit_equal"] = False
    elif breakage == "launches":
        row["launches_per_step"]["flash_attn_bwd_dq"] = 95
    elif breakage == "route":
        row["routes_per_step"] = {"fwd_wgmma": 96, "flash_fwd_simt": 72}
    elif breakage == "path":
        row["path_launches"]["flash_attn_bwd_dkv"] = 0
    elif breakage == "dispatches":
        row["dispatches"] = 61
    elif breakage == "graphs":
        row["graphs"] = row["captures"] = 16
    elif breakage == "sentinel":
        row["sentinel_events"] = 1
    elif breakage == "in_flight":
        row["in_flight"] = [8, 8, 8, 8]
    elif breakage == "parity":
        row["plain_parity"].update(ok=False, max_rel=2e-5)
    elif breakage == "interleaved":
        row["interleaved"]["losses_ok"] = False
    elif breakage == "loss":
        row["losses"] = [float("nan")]
    bad = cs.pipeline_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_profile_rounds_pad_their_windows_apart(cs):
    """Every profiling round pads its window by PROFILE_PAD spin kernels,
    well above the records the profiler was seen to lose at a window's
    start (9), and the counts leave those out."""
    assert cs.PROFILE_ROUNDS == 3 and cs.PROFILE_PAD >= 4 * 9
    assert cs.device_profile.__defaults__ == (cs.PROFILE_PAD,)
    names = ["spin_kernel(long)", "void (anonymous namespace)::fwd_wgmma<64>"]
    assert cs.kernel_launches(n for n in names
                              if cs.PAD_KERNEL not in n) == \
        {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}


# -- resnet_train ---------------------------------------------------------------

# ResNet-50's multiply-adds a 224x224 image: its 53 convolutions and the
# fc, counted from the model's shapes (conv1 alone: 112 * 112 * 64
# outputs x 3 * 7 * 7 = 118,013,952; the fc 2048 x 1000)
RESNET50_MACS = 4_089_184_256


def test_resnet50_macs_are_counted_from_the_shapes(cs):
    import torch
    from paddle_tpu_torch.vision.models import resnet50
    model = resnet50(num_classes=1000, device="cpu")
    macs = cs.layer_macs(torch, model, (1, 3, 224, 224), "cpu")
    assert len(macs) == 54 and sum(1 for k in macs if k != "fc") == 53
    assert macs["conv1"] == 118_013_952 and macs["fc"] == 2048 * 1000
    assert sum(macs.values()) == RESNET50_MACS
    assert abs(RESNET50_MACS / cs.RESNET50_CITED_MACS - 1) \
        < cs.RESNET_MACS_SLACK
    # a step is 3 x 2 flops a multiply-add: the forward and the two
    # products of the backward
    assert cs.train_flops(RESNET50_MACS, 64) == 6 * RESNET50_MACS * 64
    assert model.training


def test_layer_macs_count_groups_and_transposes(cs):
    import torch
    from paddle_tpu_torch import nn
    model = nn.Sequential(nn.Conv2D(4, 8, 3, padding=1, groups=2,
                                    device="cpu"),
                          nn.Conv2DTranspose(8, 6, 2, stride=2, groups=2,
                                             device="cpu"))
    macs = cs.layer_macs(torch, model, (1, 4, 5, 5), "cpu")
    # grouped: 8 x 5 x 5 outputs, each over 4 / 2 inputs x 9 taps
    assert macs["0"] == 8 * 25 * 2 * 9
    # transposed: each of the 8 x 5 x 5 inputs feeds 6 / 2 outputs x 4 taps
    assert macs["1"] == 8 * 25 * 3 * 4


def _resnet_row():
    return dict(captured_vs_eager=dict(losses_bit_equal=True,
                                       params_bit_equal=True,
                                       buffers_bit_equal=True),
                graphs=1, sentinel_events=0,
                card_vs_cpu=dict(max_rel=1e-6),
                losses=[7.1, 6.9], macs_per_image=RESNET50_MACS, mfu=0.3,
                eval=dict(finite=True, shape=[64, 1000]),
                flash_launches={"flash_attn_fwd": 0})


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("buffers", "bit-equal"), ("graphs", "graphs"),
    ("sentinel", "sentinel"), ("cpu", "CPU"), ("loss", "losses"),
    ("macs", "multiply-adds"), ("mfu", "MFU"), ("eval", "eval"),
    ("flash", "attention")])
def test_resnet_train_gates_name_each_failure(cs, breakage, word):
    row = _resnet_row()
    if breakage == "buffers":
        row["captured_vs_eager"]["buffers_bit_equal"] = False
    elif breakage == "graphs":
        row["graphs"] = 2
    elif breakage == "sentinel":
        row["sentinel_events"] = 1
    elif breakage == "cpu":
        row["card_vs_cpu"]["max_rel"] = 2e-3
    elif breakage == "loss":
        row["losses"] = [7.1, float("nan")]
    elif breakage == "macs":
        row["macs_per_image"] = RESNET50_MACS // 2
    elif breakage == "mfu":
        row["mfu"] = 1.5
    elif breakage == "eval":
        row["eval"]["shape"] = [64, 10]
    elif breakage == "flash":
        row["flash_launches"]["flash_attn_fwd"] = 1
    bad = cs.resnet_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


@pytest.mark.parametrize("name,category", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolutions (cuDNN)"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
     "convolutions (cuDNN)"),
    ("sm80_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32",
     "convolutions (cuDNN)"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>",
     "convolutions (cuDNN)"),
    ("void at::native::batch_norm_collect_statistics_kernel<float>",
     "batch norm"),
    ("void at::native::batch_norm_backward_elemt_kernel<float>",
     "batch norm"),
    ("bn_fw_tr_1C11_kernel_NCHW<float, float, int>", "batch norm"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>", "copies and casts"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", "matmuls (cuBLAS)"),
    ("nvjet_tst_192x192_64x3_1x2_h_bz_coopA_NTT", "matmuls (cuBLAS)"),
    ("void at::native::(anonymous namespace)::layer_norm_kernel<float>",
     "layer norm"),
])
def test_profile_categories_name_the_vision_kernels(cs, name, category):
    """The two categories the vision path adds sit ahead of the matmuls
    (cuDNN's engines share their xmma/sm90_ fragments), and the layout
    transposes count as copies."""
    got = next(c for c, keys in cs.PROFILE_CATEGORIES
               if any(k in name for k in keys))
    assert got == category


def test_max_rel_is_relative_to_the_reference_above_one(cs):
    import torch
    a = [torch.tensor([1.0, 2.5]), torch.tensor([0.5])]
    b = [torch.tensor([1.0, 2.0]), torch.tensor([0.25])]
    # 0.5 over max(1, 2.0), and 0.25 over max(1, 0.25)
    assert cs._max_rel(a, b) == 0.25


# -- yolo_train, yolo_fit, yolo_serve and the NMS kernel ----------------------

# YOLOv3() at its defaults: every convolution's multiply-adds an image,
# counted from the model's shapes (21 convolutions)
YOLO_MACS = {608: 4_742_881_536, 320: 1_313_817_600}


def test_yolov3_macs_are_counted_from_the_shapes(cs):
    import torch
    from paddle_tpu_torch.models import YOLOv3
    model = YOLOv3(device="cpu")
    for size, want in YOLO_MACS.items():
        macs = cs.layer_macs(torch, model, (1, 3, size, size), "cpu")
        assert len(macs) == 21 and sum(macs.values()) == want
    # the stem: 608 x 608 outputs x 16 channels x 3 inputs x 9 taps
    assert cs.layer_macs(torch, model, (1, 3, 608, 608), "cpu")[
        "backbone.stem.conv"] == 608 * 608 * 16 * 27


def test_yolo_synth_batch_is_train_yolos_draw(cs):
    import numpy as np
    imgs, box, lbl = cs.yolo_synth_batch(np, np.random.RandomState(0), 8,
                                         320)
    assert imgs.shape == (8, 3, 320, 320) and box.shape == (8, 50, 4)
    valid = (box[..., 2] > 0).sum(1)
    assert valid.min() >= 1 and valid.max() <= cs.YOLO_MAX_VALID
    v = box[box[..., 2] > 0]
    assert (v[:, 2:] >= 0.1).all() and (v[:, 2:] <= 0.5).all()
    assert (v[:, 0] - v[:, 2] / 2 >= 0).all() and \
        (v[:, 0] + v[:, 2] / 2 <= 1).all()
    assert lbl.dtype == np.int32 and lbl.max() < cs.YOLO_CLASSES
    assert not box[box[..., 2] == 0].any()


def test_yolo_fit_sizes_fill_both_buckets(cs):
    import numpy as np
    sizes = cs.yolo_fit_sizes(np)
    assert len(sizes) == cs.YOLO_FIT_IMAGES
    assert set(sizes) <= set(cs.YOLO_SCALES)
    small = sum(1 for s in sizes if s <= 320)
    assert small >= cs.YOLO_BATCH and len(sizes) - small >= cs.YOLO_BATCH


def test_yolo_pad_collate_pads_and_rescales(cs):
    import numpy as np
    collate = cs.yolo_pad_collate(np)
    img = np.ones((3, 352, 352), np.float32)
    box = np.zeros((50, 4), np.float32)
    box[0] = [0.5, 0.25, 0.2, 0.4]
    lbl = np.zeros(50, np.int32)
    small = (np.ones((3, 320, 320), np.float32), box.copy(), lbl)
    imgs, boxes, labels = collate([(img, box, lbl), small])
    # 352 needs the 608 canvas; the image sits at the top left
    assert imgs.shape == (2, 3, 608, 608)
    assert imgs[0, :, :352, :352].all() and not imgs[0, :, 352:].any()
    # the same pixels: a normalised coordinate scales by 352 / 608
    np.testing.assert_allclose(boxes[0, 0],
                               np.float32(352 / 608) * box[0], rtol=1e-7)
    assert not boxes[:, 1:].any()
    imgs, boxes, _ = collate([small, small])
    assert imgs.shape == (2, 3, 320, 320)
    np.testing.assert_array_equal(boxes[0], box)


def test_nms_candidates_are_sorted_with_an_invalid_tail(cs):
    import numpy as np
    boxes, scores = cs.nms_candidates(np, np.random.RandomState(0), 3, 40,
                                      False)
    assert boxes.shape == (3, 40, 4) and scores.shape == (3, 40)
    assert (np.diff(scores[:, :28], axis=-1) <= 0).all()
    assert np.isneginf(scores[:, 28:]).all()
    assert np.isfinite(scores[:, :28]).all()
    assert (boxes[..., 2:] > boxes[..., :2]).all()
    assert boxes.max() < 608 * 1.2


def test_nms_bound_counts_the_valid_pairs(cs):
    bound, by, pairs, nbytes = cs.nms_bound([400] * 640, 400)
    assert pairs == 640 * 400 * 399 // 2
    assert nbytes == 640 * 400 * 21
    assert by == "operations"
    assert bound == pytest.approx(pairs * 15 / 67e12 * 1e3)
    # no valid candidate: only the bytes
    bound, by, pairs, _ = cs.nms_bound([0, 1], 400)
    assert pairs == 0 and by == "bytes"


def test_nms_kernel_case_on_the_cpu(cs, monkeypatch):
    """_nms_case with the plain version on both sides and a host
    clock: the row's fields and the bound."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import nms
    monkeypatch.setattr(cs, "time_ms", lambda fn, reps, warmup=2: 1.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    boxes, scores = cs.nms_candidates(np, np.random.RandomState(1), 4, 30,
                                      True)
    row = cs._nms_case(torch, nms, torch.from_numpy(boxes),
                       torch.from_numpy(scores), True, 0.7, 0.9)
    assert row["masks_bit_equal"] and row["mismatches"] == 0
    assert row["problems"] == 4 and row["k"] == 30
    assert row["valid_per_problem"] == 21 and 0 < row["kept"] < 84
    assert row["iou_tests"] == 4 * 21 * 20 // 2
    assert (row["iou_threshold"], row["eta"]) == (0.7, 0.9)
    # the decay of eta 0.9 applies above 0.5: it keeps fewer boxes
    plain = cs._nms_case(torch, nms, torch.from_numpy(boxes),
                         torch.from_numpy(scores), True, 0.7, 1.0)
    assert row["kept"] < plain["kept"]


def _yolo_row():
    ok = dict(losses_bit_equal=True, params_bit_equal=True,
              buffers_bit_equal=True)
    return dict(captured_vs_eager={608: dict(ok), 320: dict(ok)},
                graphs=2, sentinel_events=0, card_vs_cpu=dict(max_rel=1e-5),
                losses=[900.0, 850.0], by_size={608: dict(mfu=0.02),
                                                320: dict(mfu=0.01)},
                flash_launches={"flash_attn_fwd": 0}, nms_launches=0)


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("replay", "bit-equal"), ("graphs", "graphs"),
    ("sentinel", "sentinel"), ("cpu", "CPU"), ("loss", "losses"),
    ("mfu", "MFU"), ("nms", "NMS")])
def test_yolo_train_gates_name_each_failure(cs, breakage, word):
    row = _yolo_row()
    if breakage == "replay":
        row["captured_vs_eager"][320]["params_bit_equal"] = False
    elif breakage == "graphs":
        row["graphs"] = 3
    elif breakage == "sentinel":
        row["sentinel_events"] = 1
    elif breakage == "cpu":
        row["card_vs_cpu"]["max_rel"] = 2e-3
    elif breakage == "loss":
        row["losses"] = [900.0, float("inf")]
    elif breakage == "mfu":
        row["by_size"][608]["mfu"] = 0.0
    elif breakage == "nms":
        row["nms_launches"] = 1
    bad = cs.yolo_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("graphs", "graphs"), ("loss", "fit"),
    ("eval", "evaluate"), ("batches", "batches")])
def test_yolo_fit_gates_name_each_failure(cs, breakage, word):
    row = dict(graphs=2, sentinel_events=0, losses=[900.0, 870.0],
               eval_loss=860.0, batches=7, expected_batches=7)
    if breakage == "graphs":
        row["graphs"] = 1
    elif breakage == "loss":
        row["losses"] = [float("nan")]
    elif breakage == "eval":
        row["eval_loss"] = float("nan")
    elif breakage == "batches":
        row["batches"] = 6
    bad = cs.yolo_fit_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("launches", "launched the NMS kernel"),
    ("index", "outputs differ"), ("finite", "non-finite"),
    ("flash", "attention")])
def test_yolo_serve_gates_name_each_failure(cs, breakage, word):
    row = dict(launches_per_hard_predict=1, finite=True,
               flash_launches={"flash_attn_fwd": 0},
               kernel_vs_plain=dict(masks_bit_equal=True,
                                    rows_bit_equal=True,
                                    counts_bit_equal=True,
                                    index_bit_equal=True))
    if breakage == "launches":
        row["launches_per_hard_predict"] = 0
    elif breakage == "index":
        row["kernel_vs_plain"]["index_bit_equal"] = False
    elif breakage == "finite":
        row["finite"] = False
    elif breakage == "flash":
        row["flash_launches"]["flash_attn_fwd"] = 12
    bad = cs.yolo_serve_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_no_top_level_name_is_defined_twice():
    """A phase's helper must not shadow another's: the later def wins
    for every caller (call 14c failed in dp_train on a second
    _timed_replays)."""
    import ast
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defs = collections.Counter(
        n.name for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    assigned = collections.Counter(
        t.id for n in tree.body if isinstance(n, ast.Assign)
        for t in n.targets if isinstance(t, ast.Name))
    assert [k for k, v in (defs + assigned).items() if v > 1] == []


def _mnist_row():
    return dict(eager=dict(test_acc=0.9, losses_head=[2.3, 2.2]),
                fit=dict(test_acc=0.88, losses_head=[2.3, 2.1]),
                card_vs_cpu_max_rel=2e-6, save_load_bit_equal=True,
                custom_kernel_launches={"flash_attn_fwd": 0,
                                        "nms_greedy": 0})


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("eager_acc", "eager: test accuracy"),
    ("fit_acc", "fit: test accuracy"), ("loss", "losses"),
    ("parity", "CPU"), ("save", "save"), ("launch", "launches")])
def test_mnist_dygraph_gates_name_each_failure(cs, breakage, word):
    row = _mnist_row()
    if breakage == "eager_acc":
        row["eager"]["test_acc"] = 0.5
    elif breakage == "fit_acc":
        row["fit"]["test_acc"] = 0.1
    elif breakage == "loss":
        row["fit"]["losses_head"] = [float("nan")]
    elif breakage == "parity":
        row["card_vs_cpu_max_rel"] = 1e-3
    elif breakage == "save":
        row["save_load_bit_equal"] = False
    elif breakage == "launch":
        row["custom_kernel_launches"]["nms_greedy"] = 1
    bad = cs.mnist_dygraph_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_ops_close_holds_each_kind(cs):
    import numpy as np
    f = np.array([1.0, 2.0, np.nan, np.inf], np.float32)
    assert cs.ops_close(np, f, f, 1e-6) == (None, 0.0)
    msg, ratio = cs.ops_close(np, f + np.float32(1e-5), f, 1e-6)
    assert msg and ratio > 1
    assert cs.ops_close(np, f[:2] * (1 + 5e-7), f[:2], 1e-6)[0] is None
    assert cs.ops_close(np, np.array([np.nan, 1.0]), np.array([1.0, 1.0]),
                        1e-6)[0] == "NaN positions differ"
    assert cs.ops_close(np, np.array([1, 2]), np.array([1, 3]), 1e-6)[0]
    assert cs.ops_close(np, np.array([1, 2], np.int32),
                        np.array([1, 2], np.int64), 1e-6)[0]


def test_ops_cases_run_on_the_cpu_as_the_card_phase_runs_them(cs):
    """ops_card's runner over the whole table with the CPU standing in
    for the card: every case runs, its tensors stay on the device asked
    for, and two runs agree exactly (the inputs and weights are drawn
    from each case's own seed)."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import place
    cases = cs.load_ops_cases()
    saved = place._current_place
    try:
        for case in cases.CASES:
            a = cs.ops_case_run(torch, pt, cases, case, "cpu")
            b = cs.ops_case_run(torch, pt, cases, case, "cpu")
            assert set(a["devices"]) <= {"cpu"}, case.id
            outs = list(zip(a["out"], b["out"])) + list(
                zip(a.get("grads", []), b.get("grads", [])))
            for x, y in outs:
                if x is None:
                    assert y is None, case.id
                    continue
                assert cs.ops_close(np, x, y, 1e-6) == (None, 0.0), case.id
    finally:
        place._current_place = saved


def test_lenet_step_and_accuracy_on_the_cpu(cs):
    """mnist_dygraph's loop and evaluation on a small MNIST on the CPU:
    the loss falls over a few steps and the accuracies agree."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision import datasets, transforms
    from paddle_tpu_torch.core import place
    from paddle_tpu_torch.vision.models import LeNet
    saved = place._current_place
    pt.set_device("cpu")
    try:
        _lenet_on_the_cpu(cs, torch, pt, datasets, transforms, LeNet)
    finally:
        place._current_place = saved


def _lenet_on_the_cpu(cs, torch, pt, datasets, transforms, LeNet):
    norm = transforms.Normalize(mean=[127.5], std=[127.5])
    train = datasets.MNIST(mode="train", synthetic_size=256, transform=norm)
    test = datasets.MNIST(mode="test", synthetic_size=64, transform=norm)
    torch.manual_seed(0)
    model = LeNet(device="cpu")
    opt = pt.optimizer.Adam(learning_rate=cs.MNIST_LR,
                            parameters=model.parameters())
    losses = [float(cs.lenet_step(pt, model, opt, x, y))
              for _ in range(3) for x, y in pt.io.DataLoader(
                  train, batch_size=cs.MNIST_BATCH)]
    assert losses[-1] < losses[0]
    acc, metric = cs.lenet_test_acc(pt, model, pt.io.DataLoader(
        test, batch_size=cs.MNIST_BATCH))
    assert 0.0 <= acc <= 1.0 and abs(acc - metric) < 1e-6


# -- the rest of paddle.nn: Transformer-base and the LSTM seq2seq ---------------

def _mt_row():
    flash = {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12,
             "flash_attn_bwd_dkv": 12}
    return dict(captured_vs_eager=dict(losses_bit_equal=True,
                                       params_bit_equal=True),
                graphs=1, sentinel_events=0, launches_per_step=flash,
                routes_per_eager_step={"flash_attention": 12,
                                       "scaled_dot_product_attention": 6},
                losses=[10.6, 10.5], card_vs_cpu=dict(max_rel=2e-6),
                mfu=0.3)


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("replay", "bit-equal"), ("graphs", "graphs"),
    ("launch", "below"), ("zero", "below"), ("route", "routes"),
    ("loss", "non-finite"), ("cpu", "CPU"), ("mfu", "MFU")])
def test_transformer_train_gates_name_each_failure(cs, breakage, word):
    row = _mt_row()
    if breakage == "replay":
        row["captured_vs_eager"]["params_bit_equal"] = False
    elif breakage == "graphs":
        row["graphs"] = 2
    elif breakage == "launch":
        row["launches_per_step"]["flash_attn_bwd_dq"] = 11
    elif breakage == "zero":
        # the plain version standing in: no kernel on the card at all
        row["launches_per_step"] = {k: 0 for k in
                                    row["launches_per_step"]}
    elif breakage == "route":
        row["routes_per_eager_step"]["scaled_dot_product_attention"] = 18
    elif breakage == "loss":
        row["losses"] = [float("nan")]
    elif breakage == "cpu":
        row["card_vs_cpu"]["max_rel"] = 2e-3
    elif breakage == "mfu":
        row["mfu"] = 1.5
    bad = cs.transformer_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def _s2s_row(cs):
    return dict(train_losses=[9.0, 8.9, 8.8],
                card_vs_cpu=dict(max_rel=1e-6),
                decode_vs_cpu=dict(max_score_rel=1e-6, near_ties=2,
                                   checked=62, ids_differ=[],
                                   rescore_off=[]),
                decode_steps=cs.S2S_MAX_STEPS)


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("loss", "non-finite"), ("train", "training losses"),
    ("scores", "beam scores"), ("ids", "ids differ"),
    ("rescore", "re-score"),
    ("steps", "steps")])
def test_rnn_seq2seq_gates_name_each_failure(cs, breakage, word):
    row = _s2s_row(cs)
    if breakage == "loss":
        row["train_losses"][1] = float("inf")
    elif breakage == "train":
        row["card_vs_cpu"]["max_rel"] = 5e-3
    elif breakage == "scores":
        row["decode_vs_cpu"]["max_score_rel"] = 2e-3
    elif breakage == "ids":
        row["decode_vs_cpu"]["ids_differ"] = [7]
    elif breakage == "rescore":
        row["decode_vs_cpu"]["rescore_off"] = [3]
    elif breakage == "steps":
        row["decode_steps"] = 0
    bad = cs.rnn_seq2seq_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_decode_agreement_sets_the_near_ties_apart(cs):
    """Near-ties are leads within S2S_TIE_FACTOR times the largest score
    difference (absolute nats, not relative to the score); ids are
    checked beyond them, and every beam's ids must re-score to its own
    score, near-ties included."""
    import numpy as np
    ref_ids = np.zeros((3, 4, 2), np.int64)
    ref_sc = np.array([[-400.0, -401.0], [-400.0, -400.0005],
                       [-300.0, -300.3]])
    sc = ref_sc + np.array([[1e-4, 0.0], [0.0, 0.0], [-2e-4, 0.0]])
    ids = ref_ids.copy()
    ids[1, 2, 0] = 5            # a near-tie: its best beam may differ
    row = cs.decode_agreement(np, ids, sc, ref_ids, ref_sc, sc, ref_sc)
    assert row["gap"] == pytest.approx(2e-4)
    assert row["tie"] == pytest.approx(cs.S2S_TIE_FACTOR * 2e-4)
    assert row["near_ties"] == 1 and row["checked"] == 2
    assert row["ids_differ"] == [] and row["rescore_off"] == []
    assert row["rescored_beams"] == 6
    # a lead of 0.3 nats at 1e-3 relative of -300 would have been a tie
    ids[2, 0, 0] = 6            # not a tie: a real difference
    assert cs.decode_agreement(np, ids, sc, ref_ids, ref_sc, sc,
                               ref_sc)["ids_differ"] == [2]
    # a near-tie's second beam whose ids are not the sequence its score
    # belongs to
    off = sc.copy()
    off[1, 1] += 0.05
    assert cs.decode_agreement(np, ids, sc, ref_ids, ref_sc, off,
                               ref_sc)["rescore_off"] == [1]
    # a decode of other length: no best beam is equal, every lead beyond
    # the (zero) gap counts
    short = cs.decode_agreement(np, ids[:, :3], ref_sc, ref_ids, ref_sc,
                                ref_sc, ref_sc)
    assert not short["same_steps"] and short["ids_differ"] == [0, 1, 2]
    far = cs.decode_agreement(np, ids, ref_sc * 1.01, ref_ids, ref_sc,
                              ref_sc * 1.01, ref_sc)
    assert far["max_score_rel"] == pytest.approx(0.01)


def test_cross_cases_are_the_decoders_shapes(cs):
    """mt_cases: Transformer-base's encoder self-attention and decoder
    cross-attention shapes, with separate q, k and v tensors (the
    layout MultiHeadAttention passes), whatever sq and sk are."""
    cases = cs.mt_cases()
    assert {(c[1], c[7]) for c in cases} == {(128, 128), (96, 128),
                                             (128, 96)}
    assert all(c[0] == 32 and c[2] == 8 and c[3] == 64 and not c[4]
               and c[8] for c in cases)
    assert {(c[5], c[6]) for c in cases} == {
        ("float32", 0.0), ("bfloat16", 0.0), ("bfloat16", cs.DROP_P)}
    assert len(cases) == 9
    assert cs._unpack((2, 16, 2, 64, True, "float32", 0.0)) == (
        2, 16, 2, 64, True, "float32", 0.0, 16, False)
    assert cs._layout(True) == "separate q, k, v"
    with pytest.raises(ValueError, match="causal"):
        cs.mask_probe_case(None, None, 2, 2, 64, 96, "bfloat16", True,
                           sk=128, separate=True)
    with pytest.raises(ValueError, match="views"):
        cs.mask_probe_case(None, None, 2, 2, 64, 96, "bfloat16", False,
                           sk=128)
    with pytest.raises(ValueError, match="views"):
        cs.attention_inputs(None, None, 2, 96, 128, 2, 64, None, False)


def _on_the_cpu(fn):
    """fn(np, torch, pt) with the port's place set to the CPU, restored
    after."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core import place
    saved = place._current_place
    pt.set_device("cpu")
    try:
        fn(np, torch, pt)
    finally:
        place._current_place = saved


def test_transformer_model_on_the_cpu_at_small_widths(cs):
    """transformer_train's model and step (mt_model, O1 bf16, dropout
    0.1, the Noam-scheduled Adam) take steps on the CPU, the 2 + 2
    layers' attention routes counted as the card phase counts them."""
    def run(np, torch, pt):
        cfg = dict(cs.MT_TINY, dropout=0.1)
        _, step, _, x, y = cs._mt_step(torch, pt, cfg, 97, (3, 12, 9),
                                       "cpu")
        with cs._CountCalls(pt.nn.functional, (
                "flash_attention", "scaled_dot_product_attention")) as r:
            losses = [float(step(x, y, seed=s)) for s in cs.STEP_SEEDS[:2]]
        assert all(np.isfinite(losses))
        assert r.counts == {"flash_attention": 4 * 2,
                            "scaled_dot_product_attention": 2 * 2}
    _on_the_cpu(run)


def _s2s_pair(cs, np, pt):
    import paddle_tpu as jp
    from paddle_tpu_torch.models import load_jax_params
    jp.seed(3)
    jm = cs.seq2seq_model(jp, **cs.S2S_TINY)
    tm = cs.seq2seq_model(pt, **cs.S2S_TINY)
    load_jax_params(tm, {k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    return jp, jm, tm, cs.seq2seq_batch(np, 4, 7, 6, 23, 11)


def test_seq2seq_model_trains_on_the_cpu_as_in_jax(cs):
    """rnn_seq2seq's model and eager steps at S2S_TINY in both packages
    from the same weights: the losses of 2 steps at 1e-5."""
    def run(np, torch, pt):
        jp, jm, tm, arrays = _s2s_pair(cs, np, pt)
        jl = cs.seq2seq_train(jp, jm, [jp.to_tensor(a) for a in arrays], 2)
        tl = cs.seq2seq_train(pt, tm, [torch.from_numpy(a)
                                       for a in arrays], 2)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tl[-1] < tl[0]
    _on_the_cpu(run)


def test_seq2seq_beam_decode_on_the_cpu_as_in_jax(cs):
    """rnn_seq2seq's beam_decode at S2S_TINY in both packages from the
    same weights: ids equal, scores at 1e-5 (decode_agreement)."""
    def run(np, torch, pt):
        jp, jm, tm, arrays = _s2s_pair(cs, np, pt)
        jm.eval()
        tm.eval()
        jids, jsc = cs.beam_decode(jp, jm, jp.to_tensor(arrays[0]), beam=3,
                                   max_steps=8)
        with torch.no_grad():
            tids, tsc = cs.beam_decode(pt, tm, torch.from_numpy(arrays[0]),
                                       beam=3, max_steps=8)
        src = arrays[0]
        with torch.no_grad():
            trs = cs.seq2seq_rescore(np, pt, tm, torch.from_numpy(src),
                                     tids.numpy())
        jrs = cs.seq2seq_rescore(np, jp, jm, jp.to_tensor(src),
                                 np.asarray(jids.numpy()))
        agree = cs.decode_agreement(np, tids.numpy(), tsc.numpy(),
                                    np.asarray(jids.numpy()),
                                    np.asarray(jsc.numpy()), trs, jrs,
                                    rtol=1e-5)
        assert agree["ids_differ"] == [] and agree["max_score_rel"] < 1e-5
        assert agree["best_ids_equal"] == 4 and agree["rescore_off"] == []
        # the re-score is each beam's score of the same ids, in both
        # packages
        np.testing.assert_allclose(trs, tsc.numpy(), rtol=1e-5)
        np.testing.assert_allclose(jrs, np.asarray(jsc.numpy()), rtol=1e-5)
    _on_the_cpu(run)


def test_seq2seq_rescore_catches_a_wrong_back_trace(cs, monkeypatch):
    """A gather_tree that ignores the parent pointers gives ids that are
    not the sequences their beam scores belong to: decode_agreement's
    re-score names those sentences, near-ties or not."""
    def run(np, torch, pt):
        from paddle_tpu_torch.nn import decode
        _, _, tm, arrays = _s2s_pair(cs, np, pt)
        tm.eval()
        src = torch.from_numpy(arrays[0])

        def go():
            with torch.no_grad():
                ids, sc = cs.beam_decode(pt, tm, src, beam=3, max_steps=8)
                ids, sc = ids.numpy(), sc.numpy()
                return ids, sc, cs.seq2seq_rescore(np, pt, tm, src, ids)
        ids, sc, rs = go()
        monkeypatch.setattr(decode, "gather_tree", lambda i, p: i)
        bids, bsc, brs = go()
        ok = cs.decode_agreement(np, ids, sc, ids, sc, rs, rs)
        bad = cs.decode_agreement(np, bids, bsc, ids, sc, brs, rs)
        assert ok["rescore_off"] == [] and bad["max_score_rel"] == 0.0
        assert bad["rescore_off"] != []
    _on_the_cpu(run)


# -- the op library's second half: head_dim 256 and the CoNLL-2005 SRL ----

def test_head_dim_256_cases_and_rows(cs):
    """head_pad runs 192 (padded to 256) and 256; the d256 file's
    instantiations are its 2 f32 backward kernels x causal x dropout (the
    f32 forward at 256 is the wide file's cluster forward), the wg256
    file's its 3 bf16 kernels x causal x dropout; the kernels line's
    rows carry each case's device kernel, times, bound and SDPA's, and
    the f32 forward's row its cluster of one."""
    assert {192, 256} <= set(cs.PAD_HEAD_DIMS) and cs.D256_SHAPE[3] == 256
    assert cs.D256_INSTANTIATIONS == 2 * 2 * 2
    assert cs.WG256_INSTANTIATIONS == 3 * 2 * 2
    case = dict(dtype="bfloat16", b=8, s=1024, sk=1024, n=8, h=256,
                layout="qkv views",
                causal=True, dropout_p=0.1, fwd_ms=4.5,
                fwd_plain_ms=30.0, fwd_bound_ms=0.04, fwd_bound_by="bytes",
                fwd_library_ms=0.3, dq_ms=6.0, dq_plain_ms=20.0,
                dq_bound_ms=0.05, dq_bound_by="operations", dkv_ms=6.2,
                dkv_plain_ms=21.0, dkv_bound_ms=0.06,
                dkv_bound_by="operations", backward_library_ms=0.4,
                o_max_abs_err=1e-3, dq_max_abs_err=2e-3,
                dk_max_abs_err=3e-3, dv_max_abs_err=4e-3)
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    cases = [case, dict(case, dtype="float32")]
    for c in cases:
        cs.kernel_clusters(torch, fa, c)
    rows = cs.d256_kernel_rows(cases)
    assert [[r["kernel"] for r in rows[k]] for k in cs.KERNEL_EVENTS] == [
        ["fwd_wg256", "fwd_wide"], ["dq_wg256", "dq_d256"],
        ["dkv_wg256", "dkv_d256"]]
    assert [[r["cluster"] for r in rows[k]] for k in cs.KERNEL_EVENTS] == [
        [None, {"size": 1, "chunks_per_cta": 1}], [None, None],
        [None, None]]
    assert rows["flash_attn_fwd"][0]["library_ms"] == 0.3
    assert rows["flash_attn_bwd_dq"][0]["backward_library_ms"] == 0.4
    assert rows["flash_attn_bwd_dkv"][0]["max_abs_err"] == 4e-3
    assert rows["flash_attn_bwd_dkv"][0]["bound_by"] == "operations"
    assert (rows["flash_attn_fwd"][0]["s"], rows["flash_attn_fwd"][0]["h"]) \
        == (1024, 256)


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::fwd_wg256<false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, Args)", "flash_attn_fwd"),
    ("void (anonymous namespace)::dq_wg256<true, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Args)",
     "flash_attn_bwd_dq"),
    ("void (anonymous namespace)::dkv_wg256<false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Args)",
     "flash_attn_bwd_dkv"),
    ("void (anonymous namespace)::dkv_d256<float, false, true>(Args)",
     "flash_attn_bwd_dkv"),
    ("void (anonymous namespace)::fwd_wgwide<true, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, Args)", "flash_attn_fwd"),
    ("void (anonymous namespace)::fwd_wide<true, false>(WideArgs, Cluster)",
     "flash_attn_fwd"),
    ("void (anonymous namespace)::dq_wide<float, false, false>(WideArgs)",
     "flash_attn_bwd_dq"),
    ("void (anonymous namespace)::dq_wgwide<true, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Args)",
     "flash_attn_bwd_dq"),
    ("void (anonymous namespace)::dkv_wgwide<false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, Args)",
     "flash_attn_bwd_dkv"),
])
def test_head_dim_256_kernels_count_for_their_wrapper(cs, name, wrapper):
    """The head_dim-256 and wide kernels' profiler names count for the
    wrapper that launches them, by the route D256_ROUTES or WIDE_ROUTES
    names, and their time for the attention category."""
    got = cs.kernel_launches([name])
    assert got == {k: int(k == wrapper) for k in cs.KERNEL_EVENTS}
    cat = next(c for c, keys in cs.PROFILE_CATEGORIES
               if any(k in name for k in keys))
    assert cat == "flash attention kernels"
    dtype = ("float32" if "float" in name or "fwd_wide<" in name
             else "bfloat16")
    routes = cs.D256_ROUTES if "256" in name else cs.WIDE_ROUTES
    assert routes[dtype][wrapper] in name


def _encoder_256_row():
    one = {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
           "flash_attn_bwd_dkv": 1}
    return dict(
        captured_vs_eager=dict(losses_bit_equal=True, params_bit_equal=True),
        graphs=1, sentinel_events=0, launches_per_step=dict(one),
        warmup_launches=dict(one),
        routes_per_step={"fwd_wg256": 1, "dq_wg256": 1, "dkv_wg256": 1},
        losses=[2.0, 1.98, 1.7])


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("replay", "bit-equal"), ("graphs", "graphs"),
    ("launches", "one of each"), ("route", "expected"),
    ("nan", "non-finite")])
def test_encoder_256_gates_name_each_failure(cs, breakage, word):
    """The head_dim-256 training phase fails on a replay that is not
    bit-equal to eager, a second graph, a kernel launched other than
    once a step, another route than the three wgmma kernels (an FFMA
    dK/dV in bf16 would be the old route), and a non-finite loss."""
    row = _encoder_256_row()
    if breakage == "replay":
        row["captured_vs_eager"]["losses_bit_equal"] = False
    elif breakage == "graphs":
        row["graphs"] = 2
    elif breakage == "launches":
        row["launches_per_step"]["flash_attn_bwd_dq"] = 2
    elif breakage == "route":
        row["routes_per_step"] = {"fwd_wg256": 1, "dq_wg256": 1,
                                  "dkv_d256": 1}
    elif breakage == "nan":
        row["losses"][2] = float("nan")
    bad = cs.encoder_256_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def _srl_row():
    return dict(
        captured_vs_eager=dict(losses_bit_equal=True, params_bit_equal=True,
                               params_max_abs_diff=0.0,
                               graph_losses=[30.0, 20.0]),
        graphs=1, sentinel_events=0, params=100, params_book=100,
        loss_first_window=30.0,
        loss_last_window=10.0, card_vs_cpu=dict(max_rel=2e-6),
        decode_vs_cpu=dict(rescore_off=[], differ_outside_ties=[]),
        custom_kernel_launches={"flash_attn_fwd": 0, "nms_greedy": 0})


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("replay", "bit-equal"), ("graphs", "graphs"),
    ("params", "widths"), ("nan", "non-finite"), ("cpu", "CPU"), ("rescore", "re-score"),
    ("paths", "near-ties"), ("loss", "did not fall"),
    ("launch", "kernels")])
def test_srl_train_gates_name_each_failure(cs, breakage, word):
    row = _srl_row()
    if breakage == "replay":
        row["captured_vs_eager"]["params_bit_equal"] = False
    elif breakage == "graphs":
        row["graphs"] = 2
    elif breakage == "params":
        row["params"] = 99
    elif breakage == "nan":
        row["captured_vs_eager"]["graph_losses"][1] = float("nan")
    elif breakage == "cpu":
        row["card_vs_cpu"]["max_rel"] = 1e-3
    elif breakage == "rescore":
        row["decode_vs_cpu"]["rescore_off"] = [4]
    elif breakage == "paths":
        row["decode_vs_cpu"]["differ_outside_ties"] = [9]
    elif breakage == "loss":
        row["loss_last_window"] = 31.0
    elif breakage == "launch":
        row["custom_kernel_launches"]["flash_attn_fwd"] = 3
    bad = cs.srl_train_gates(row)
    if breakage is None:
        assert bad == []
    else:
        assert len(bad) == 1 and word in bad[0], bad


def test_srl_model_at_the_books_widths(cs):
    """srl_param_count at the book's widths, term by term: the three
    tables, the eight input fcs, 8 LSTMs (recurrent [512, 128] and a
    bias), the 7 mixing pairs of fcs, the two output fcs and crfw [11,
    9]; and the model srl_model builds at a small size has as many."""
    c = cs.SRL
    h, u, lab = c["hidden_dim"], c["hidden_dim"] // 4, c["label_dict_len"]
    want = (c["word_dict_len"] * c["word_dim"]
            + c["pred_dict_len"] * c["word_dim"]
            + c["mark_dict_len"] * c["mark_dim"]
            + 7 * (c["word_dim"] * h + h) + (c["mark_dim"] * h + h)
            + c["depth"] * (h * u + h)
            + (c["depth"] - 1) * ((h * h + h) + (u * h + h))
            + (h * lab + lab) + (u * lab + lab) + (lab + 2) * lab)
    assert cs.srl_param_count(**c) == want
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    m = cs.srl_model(pt, **cs.SRL_TINY)
    assert sum(p.numel() for p in m.parameters()) == \
        cs.srl_param_count(**cs.SRL_TINY)


# -- item 17 with item 7's rest: head_dim above 256, the captured loop,
# the sentry ---------------------------------------------------------------

def test_wide_cases_and_rows(cs):
    """The wide FFMA kernels' instantiations are 3 kernels in f32 x
    causal x dropout, the wgmma kernels' 3 in bf16 x causal x dropout;
    320 runs padded (no kernel row), 512 and 1024 on the kernels'
    entries give the kernels line's rows, each naming its device kernel
    and its case's shape; the hard bf16 cases run on the kernels' own
    head_dims, cross-attention on separate q, k and v."""
    from paddle_tpu_torch.ops import flash_attention as fa
    assert cs.WIDE_INSTANTIATIONS == 3 * 2 * 2
    assert cs.WGWIDE_INSTANTIATIONS == 3 * 2 * 2
    hard = [cs._unpack(c) for c in cs.WIDE_HARD_CASES]
    assert all(fa.kernel_head_dim(c[3]) == c[3] > 256 and c[5] == "bfloat16"
               and (c[8] or c[1] == c[7]) for c in hard)
    assert {768} <= {c[3] for c in hard} and min(c[2] for c in hard) == 1
    assert [fa.kernel_head_dim(h) for h in cs.WIDE_HEAD_DIMS] == \
        [512, 512, 1024]
    kernel = dict(dtype="float32", b=2, s=512, sk=512, n=4, h=1024,
                  layout="qkv views",
                  causal=False, dropout_p=0.0, fwd_ms=1.6,
                  fwd_plain_ms=1.3, fwd_bound_ms=0.1, fwd_bound_by="operations",
                  fwd_library_ms=0.2, dq_ms=2.0, dq_plain_ms=3.0,
                  dq_bound_ms=0.2, dq_bound_by="operations", dkv_ms=2.1,
                  dkv_plain_ms=3.1, dkv_bound_ms=0.2,
                  dkv_bound_by="operations", backward_library_ms=0.7,
                  o_max_abs_err=1e-6, dq_max_abs_err=2e-6,
                  dk_max_abs_err=3e-6, dv_max_abs_err=1e-6)
    padded = dict(h=320, kernel_head_dim=512, entry_fwd_bwd_ms=4.0)
    rows = cs.wide_kernel_rows([padded, kernel])
    assert [len(v) for v in rows.values()] == [1, 1, 1]
    assert rows["flash_attn_bwd_dkv"][0]["max_abs_err"] == 3e-6
    assert rows["flash_attn_fwd"][0]["kernel"] == "fwd_wide"
    bf16 = cs.wide_kernel_rows([dict(kernel, dtype="bfloat16")])
    assert [r[0]["kernel"] for r in bf16.values()] == [
        "fwd_wgwide", "dq_wgwide", "dkv_wgwide"]
    assert rows["flash_attn_fwd"][0]["h"] == 1024
    import torch
    cs.kernel_clusters(torch, fa, kernel)
    rows = cs.wide_kernel_rows([kernel])
    assert rows["flash_attn_bwd_dq"][0]["cluster"] == {
        "size": 4, "chunks_per_cta": 1}
    # the forward runs in the same cluster as the backward
    assert rows["flash_attn_fwd"][0]["cluster"] == \
        rows["flash_attn_bwd_dq"][0]["cluster"]


def test_wide_f32_hard_cases_and_cluster_rows(cs):
    """The f32 hard cases are WIDE_HARD_CASES' twins in f32 (the same
    shapes on the cluster backward); D 2304 has nine chunks, more than a
    portable cluster, so a CTA owns two (a cluster of 5), at p 0 and
    DROP_P, causal and not; an f32 row names its cluster, a bf16 row
    none."""
    from paddle_tpu_torch.ops import flash_attention as fa
    assert [c[:5] + c[6:] for c in cs.WIDE_HARD_CASES_F32] == \
        [c[:5] + c[6:] for c in cs.WIDE_HARD_CASES]
    assert {c[5] for c in cs.WIDE_HARD_CASES_F32} == {"float32"}
    big = [cs._unpack(c) for c in cs.WIDE_2304_CASES]
    assert {(c[4], c[6]) for c in big} == {
        (causal, p) for causal in (False, True) for p in (0.0, cs.DROP_P)}
    assert all(c[3] == 2304 and c[5] == "float32" for c in big)
    assert fa.wide_cluster(2304) == (5, 2)
    import torch
    row = dict(dtype="float32", h=2304)
    cs.kernel_clusters(torch, fa, row)
    assert row["clusters"] == {k: {"size": 5, "chunks_per_cta": 2}
                               for k in cs.KERNEL_EVENTS}
    row = dict(dtype="bfloat16", h=1024)
    cs.kernel_clusters(torch, fa, row)
    assert row["clusters"] == {k: None for k in cs.KERNEL_EVENTS}
    assert cs.ENCWIDE_ATTN_F32[5] == "float32" and \
        cs.ENCWIDE_ATTN_F32[:5] == cs.ENCWIDE_ATTN[:5]
    assert cs.ENCODERS["encoder_wide_f32"][1] == cs.WIDE_ROUTES["float32"]
    assert cs.ENCODERS["encoder_wide_f32"][2] is None


def test_collatz_loop_counts_the_trips_on_the_cpu(cs):
    """graph_while's loop, eagerly: steps per lane and the trips (the
    largest lane's steps)."""
    import torch
    from paddle_tpu_torch.ops import control_flow as tcf
    vals, steps, trips = cs._collatz(torch, tcf, torch.tensor([27, 97, 1, 6]))
    assert steps.tolist() == [111, 118, 0, 8]
    assert vals.tolist() == [1, 1, 1, 1] and int(trips) == 118


def test_stats_agree_is_exact_on_counts_and_max(cs):
    want = {"mlp": {"nonfinite": 0, "max_abs": 2.5, "l2": 10.0}}
    ok, gap = cs._stats_agree({"mlp": dict(want["mlp"], l2=10.00001)},
                              want, 1e-4)
    assert ok and gap == pytest.approx(1e-6)
    for bad in ({"nonfinite": 1}, {"max_abs": 2.5000001}, {"l2": 10.01}):
        assert not cs._stats_agree({"mlp": dict(want["mlp"], **bad)},
                                   want, 1e-4)[0]
    assert not cs._stats_agree({}, want, 1e-4)[0]


def _numeric_run(healthy=True):
    control, kill = _elastic_runs()
    fault = dict(step=5, reason="numeric fault at step 5: nonfinite "
                 "(grad.nonfinite)", health={"healthy": False},
                 anomalies=[{"kind": "nonfinite"}])
    first, second = kill["incs"]
    first = dict(first, fault=fault)
    second = dict(second, candidate_steps=[5, 3, 1], require_healthy=True,
                  resume_health={"healthy": healthy})
    run = dict(kill, name="numeric", mode="nan_grad", incs=[first, second],
               receipts=[{"action": "respawn_gang", "backoff_s": 0.1,
                          "verdict": {"kind": "numeric", "rank": 0}}],
               manifest=dict(kill["manifest"],
                             **{"['train']['strategy_state']['sentry_fp']":
                                {"crc32": 9}}))
    return control, run


@pytest.mark.parametrize("breakage,word", [
    (None, None), ("unhealthy", "fault"), ("verdict", "receipts")])
def test_elastic_numeric_case_gates(cs, breakage, word):
    control, run = _numeric_run(healthy=breakage != "unhealthy")
    if breakage == "verdict":
        run["receipts"][0]["verdict"]["kind"] = "crash"
    row, bad = cs._elastic_row(run, control)
    if breakage is None:
        assert bad == [] and row["resume_step"] == cs.ELASTIC_PROBE + 1
        assert row["fault"]["step"] == 5 and row["sentry_leaves"] == 1
    else:
        assert len(bad) == 1 and word in bad[0], bad


def _path_row(routes):
    one = {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
           "flash_attn_bwd_dkv": 1}
    return dict(launches=dict(one), launches_per_step=dict(one),
                step_ms=33.0, attention_share=0.06,
                routes_per_step={name: 1 for name in routes.values()})


def _attn_case(attn):
    b, s, n, h, causal, dt, p, sk, sep = attn
    case = dict(dtype=dt, b=b, s=s, sk=sk, n=n, h=h, causal=causal,
                dropout_p=p, layout=("separate q, k, v" if sep
                                     else "qkv views"),
                backward_ms=1.5, backward_library_ms=1.4,
                fwd_library_ms=0.5, fwd_device_ms=0.3)
    for t in ("fwd", "dq", "dkv"):
        case.update({f"{t}_ms": 0.4, f"{t}_plain_ms": 20.0,
                     f"{t}_bound_ms": 0.1, f"{t}_bound_by": "operations"})
    for o in ("o", "dq", "dk", "dv"):
        case[f"{o}_max_abs_err"] = 1e-3
    return case


def test_encoder_kernel_rows_name_each_paths_kernels(cs):
    """The kernels line's rows of the encoder paths: at head_dim 256 the
    three bf16 wgmma kernels of flash_attn_wg256.cu, at 512 the three of
    flash_attn_wgwide.cu and, in f32 (encoder_wide_f32), the three FFMA
    kernels of flash_attn_wide.cu, each with its path's launches and the
    times of the case at the path's attention shape (in its dtype); a
    path that launched no kernel of one kind fails."""
    paths = {key: _path_row(entry[1]) for key, entry in cs.ENCODERS.items()}
    cases = [_attn_case(cs.ENC256_ATTN), _attn_case(cs.ENCWIDE_ATTN),
             _attn_case(cs.ENCWIDE_ATTN_F32)]
    rows = cs.encoder_kernel_rows(paths, cases)
    assert [(r["name"], r["source"].rsplit("/", 1)[1], r["path"])
            for r in rows] == [
        ("flash_attn_fwd_wg256", "flash_attn_wg256.cu", "encoder_256"),
        ("flash_attn_bwd_dq_wg256", "flash_attn_wg256.cu", "encoder_256"),
        ("flash_attn_bwd_dkv_wg256", "flash_attn_wg256.cu", "encoder_256"),
        ("flash_attn_fwd_wgwide", "flash_attn_wgwide.cu", "encoder_wide"),
        ("flash_attn_bwd_dq_wgwide", "flash_attn_wgwide.cu", "encoder_wide"),
        ("flash_attn_bwd_dkv_wgwide", "flash_attn_wgwide.cu",
         "encoder_wide"),
        ("flash_attn_fwd_wide", "flash_attn_wide.cu", "encoder_wide_f32"),
        ("flash_attn_bwd_dq_wide", "flash_attn_wide.cu", "encoder_wide_f32"),
        ("flash_attn_bwd_dkv_wide", "flash_attn_wide.cu",
         "encoder_wide_f32")]
    assert [r["shape"].split()[4] for r in rows] == \
        ["bfloat16"] * 6 + ["float32"] * 3
    assert all(r["launches"] == 1 for r in rows)
    assert rows[3]["device_ms"] == 0.3 and rows[4]["library_ms"] is None
    assert rows[2]["replaces"].startswith(
        "paddle_tpu/ops/pallas_kernels.py:319 (head_dim 256")
    paths["encoder_wide"]["launches"]["flash_attn_bwd_dkv"] = 0
    with pytest.raises(SystemExit):
        cs.encoder_kernel_rows(paths, cases)


def test_encoder_wide_gates_take_its_routes(cs):
    """encoder_wide's replay must run the three wgmma kernels above 256
    once each: the head_dim-256 routes there are a failure."""
    routes = cs.ENCODERS["encoder_wide"][1]
    row = dict(_encoder_256_row(),
               routes_per_step={name: 1 for name in routes.values()})
    assert cs.encoder_256_gates(row, routes) == []
    assert cs.ENCWIDE["d_model"] // cs.ENCWIDE["nhead"] == \
        cs.ENCWIDE_ATTN[3] == 512
    bad = cs.encoder_256_gates(_encoder_256_row(), routes)
    assert len(bad) == 1 and "expected" in bad[0]
