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
