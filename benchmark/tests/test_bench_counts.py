"""FLOP and byte counts at the configurations' shapes against hand
counts, and the per-layer readers on hand-made runs."""

import math

import pytest

from benchmark import flops, tracing

S = flops.Shape(hidden=768, heads=12, inter=1024, enc_layers=12,
                dec_layers=12, max_pos=128)


def test_linear_and_attention_by_hand():
    h, i, b, l = 768, 1024, 64, 128
    tok = b * l
    # one encoder layer: Q K V O, the MLP, and the core with its table
    per_layer = (4 * 2 * tok * h * h + 2 * 2 * tok * h * i
                 + 3 * 2 * b * l * l * h)
    assert flops._bert_flops(S, b, l) == per_layer
    # a decoder layer adds cross Q and O on the ligand, K and V on the
    # pocket, and a core without a table
    cross = 2 * 2 * tok * h * h + 2 * 2 * tok * h * h + 2 * 2 * b * l * l * h
    assert flops._bert_flops(S, b, l, l) == per_layer + cross


def test_train_step_is_three_forwards():
    fwd = flops.structure_forward_flops(S, 64, 128, 128)
    assert flops.train_step_flops(S, 64, 128, 128) == 3 * fwd
    # about 2.48 TFLOP a forward at B=64, 128 + 128
    assert 2.4e12 < fwd < 2.6e12


def test_sample_batch_counts_one_encode_and_every_decode():
    s = flops.Shape(768, 12, 1024, 12, 12, 64)
    one = flops.structure_decode_flops(s, 64, 64, 64, cross_kv=False)
    full = flops.sample_batch_flops(s, 64, 64, 64, 1000)
    rest = flops.structure_encode_flops(s, 64, 64) + flops.cross_kv_flops(
        s, 64, 64)
    assert math.isclose(full, rest + 1000 * one)


def test_attention_least_time_is_bytes_bound_at_training_shape():
    a = flops.Attn(64, 128, 128, True)
    q = 64 * 128 * 768 * 2
    table = 255 * 64 * 2
    fwd_bytes = 4 * q + 4 * 64 * 128 + table + 4 * 64 * 12 * 128
    want = fwd_bytes / flops.PEAK_BYTES
    assert math.isclose(flops.attention_least_s(a, S, False), want)
    # the forward's 50.8 MB, as the port's kernel table bounds it
    assert 50e6 < fwd_bytes < 51.5e6


def test_layernorm_least_time_by_hand():
    n = flops.Norm(8192, True)
    fwd = 8192 * 768 * 3 * 2
    bwd = 8192 * 768 * 4 * 2
    assert math.isclose(flops.layernorm_least_s(n, S, True),
                        (fwd + bwd) / flops.PEAK_BYTES)


def test_call_lists_match_the_model():
    attn, norms = flops.encode_calls(S, 2, 16)
    assert len(attn) == 13 and len(norms) == 5 + 24
    attn, norms = flops.decode_calls(S, 2, 8, 16)
    assert len(attn) == 1 + 24 and sum(not a.table for a in attn) == 12
    assert len(norms) == 4 + 36 + 1


class _Run:
    def __init__(self, profile, facts, config):
        self.profile, self.facts, self.config = profile, facts, config


def _reader(name):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m_" + name.replace(
        ".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


CONF = {"structure": {"hidden_size": 768, "num_attention_heads": 12,
                      "intermediate_size": 1024, "num_hidden_layers": 12,
                      "max_seq_len": 128},
        "sample": {"max_seq_len": 64}}


def test_roofline_reader_is_least_time_over_kernel_time():
    ops = {"void attention_mma_kernel<8, true, true>(Args, float)": 2e6,
           "void attention_bwd_mma_kernel<8, true>(BwdArgs)": 6e6,
           "nvjet_tst_gemm": 9e6}
    run = _Run({"ops": ops, "busy_s": 1.0, "window_s": 1.0},
               {"traced_steps": 2, "batch": 64, "length": 128}, CONF)
    got = _reader("attention_roofline.train")(run)
    a, _ = flops.encode_calls(S, 64, 128)
    d, _ = flops.decode_calls(S, 64, 128, 128)
    least = flops.family_least_s("attention", a + d, S, True)
    assert math.isclose(got, 100 * 2 * least / 8.0)


def test_readers_find_nothing_and_say_so():
    run = _Run({"ops": {"nvjet": 1.0}, "busy_s": 1.0, "window_s": 1.0},
               {"traced_steps": 2, "batch": 64, "length": 128}, CONF)
    assert _reader("layernorm_roofline.train")(run) is None
    run = _Run(None, {}, CONF)
    assert _reader("device_idle.train")(run) is None
    assert _reader("train_mfu")(run) is None


def test_mfu_reader():
    run = _Run(None, {"step_s": 0.05, "batch": 64, "length": 128}, CONF)
    want = 100 * flops.train_step_flops(S, 64, 128, 128) / 0.05 / 989e12
    assert math.isclose(_reader("train_mfu")(run), want)
    assert 10 < want < 20


def test_kernel_families():
    ops = {"void layernorm_vec_kernel<bf16, 768>(x)": 1e6,
           "column_sum_kernel(float const*)": 1e6,
           "void attention_bwd_dq_kernel(BwdArgs)": 3e6,
           "table_grad_sum_kernel(float4 const*)": 1e6,
           "void at::native::vectorized_elementwise_kernel<8>": 5e6}
    assert tracing.family_seconds(ops, "layernorm") == pytest.approx(2.0)
    assert tracing.family_seconds(ops, "attention") == pytest.approx(4.0)
