"""The FLOP and byte formulas of the metrics, against hand counts, and the
readers on hand-made records."""

import pytest

import os

from portbench.harness import metric_reader, load_module, PKG_DIR
from portbench import devtrace

PEAKS = {"bf16_flop_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def _metric(name):
    return load_module(os.path.join(PKG_DIR, "metrics", name + ".py"), "t_" + name)


def _block():
    return load_module(os.path.join(PKG_DIR, "configs", "gpt_block.py"), "t_gpt_block")


def test_model_flops_tiny_by_hand():
    port = {"d_model": 4, "d_ff": 8, "n_layers": 1, "vocab_size": 10, "n_heads": 2}
    # matmuls: qkv 4x12, out 4x4, ff 4x8 and 8x4, head 4x10: 48+16+32+32+40 = 168
    # params, 6 FLOPs each per token, 2 tokens: 2016. Attention: 2 heads of
    # d 2, causal pairs 1 + 2 = 3 per head, 6 dots of 2 * 2 FLOPs: 2*3*6*4.
    assert _block().model_flops_per_step(port, 1, 2) == 2016 + 144


def test_model_flops_gpt2_medium_counts_the_published_matmuls():
    port = {"d_model": 1024, "d_ff": 4096, "n_layers": 24, "vocab_size": 50257, "n_heads": 16}
    # 353,503,232 parameters, less 49 norm scales of 1024: the matmuls.
    matmul_params = 353_503_232 - 49 * 1024
    attn = 24 * 6 * 2 * 64 * 16 * 16 * (1024 * 1025 // 2)
    assert _block().model_flops_per_step(port, 16, 1024) == \
        6 * matmul_params * 16 * 1024 + attn


@pytest.mark.parametrize("stem,us", [("flash_fwd", 1.262), ("flash_bwd_dq", 1.585),
                                     ("flash_bwd_dkv", 1.898)])
def test_flash_bounds_match_the_kernel_table(stem, us):
    # PERF.md's kernel table: BH 32, S 256, D 64, bf16, bound by bytes.
    least = _metric("flash_roofline").least_seconds(stem, 32, 256, 64, 2, PEAKS)
    assert least * 1e6 == pytest.approx(us, abs=5e-4)


def test_flash_bound_by_operations_at_long_sequences():
    least = _metric("flash_roofline").least_seconds("flash_fwd", 128, 2048, 256, 2, PEAKS)
    flops = 2 * 2 * 256 * 128 * (2048 * 2049 // 2)
    assert least == pytest.approx(flops / 989e12)


def _record(**kw):
    port = {"d_model": 64, "d_ff": 128, "n_layers": 1, "vocab_size": 10, "n_heads": 2,
            "dtype": "bfloat16"}
    rec = {"config": {"port": port}, "traffic": {"batch": 2, "seq_len": 8}, "peaks": PEAKS,
           "setup_s": 3.5, "telemetry": {"take": [], "restore": []}, "trace": None,
           "flops_per_step": 7.0e9, "resumes": {"count": 2, "seconds": 1.0},
           "window": {"seconds": 2.0, "steps": 10, "tokens_per_step": 16, "takes": 4,
                      "stall_s": 0.2, "take_call_s": 0.12, "take_wait_s": 0.08,
                      "ckpt_s": 1.0}}
    rec.update(kw)
    return rec


def test_end_to_end_readers():
    rec = _record()
    assert metric_reader("goodput_tokens_per_s")(rec) == 80.0
    assert metric_reader("save_stall_ms")(rec) == pytest.approx(50.0)
    assert metric_reader("restore_s")(rec) == 0.5
    assert metric_reader("setup_s")(rec) == 3.5
    assert metric_reader("take_call_ms")(rec) == pytest.approx(30.0)
    assert metric_reader("take_wait_ms")(rec) == pytest.approx(20.0)
    assert metric_reader("train_mfu")(rec) == pytest.approx(100 * 7.0e10 / (1.0 * 989e12))
    assert metric_reader("goodput_tokens_per_s.ckpt")(rec) == 80.0


def test_readers_find_nothing_and_say_so():
    rec = _record(window={"seconds": 2.0, "steps": 10, "tokens_per_step": 16, "takes": 0,
                          "stall_s": 0.0, "take_call_s": 0.0, "take_wait_s": 0.0,
                          "ckpt_s": 0.0}, resumes={"count": 0, "seconds": 0.0})
    for name in ("save_stall_ms", "restore_s", "take_call_ms", "take_wait_ms",
                 "flash_roofline", "device_idle",
                 "take_stage_ms", "take_write_ms", "restore_decode_ms"):
        assert metric_reader(name)(rec) is None, name


def test_trace_readers():
    kernels = {"void flash_fwd_wgmma_kernel<__nv_bfloat16, 64>(CUtensorMap_st)": [2, 4e-6],
               "_Z25flash_bwd_dq_wgmma_kernelI": [2, 4e-6],
               "flash_bwd_dkv_wgmma_kernel<64>": [2, 4e-6],
               "ampere_bf16_s16816gemm": [5, 1.0]}
    rec = _record(trace={"window_s": 4.0, "busy_s": 3.0, "kernels": kernels, "idle_gaps": {}})
    fr = _metric("flash_roofline")
    least = sum(2 * fr.least_seconds(s, 4, 8, 32, 2, PEAKS) for s in fr.KERNELS)
    assert metric_reader("flash_roofline")(rec) == pytest.approx(100 * least / 12e-6)
    assert metric_reader("device_idle")(rec) == pytest.approx(25.0)


def test_telemetry_readers_average_over_ops():
    rec = _record(telemetry={"take": [{"stage_copy": 0.1, "storage_write": 0.3},
                                      {"stage_copy": 0.3}],
                             "restore": [{"decode": 0.2, "storage_read": 0.1}]})
    assert metric_reader("take_stage_ms")(rec) == pytest.approx(200.0)
    assert metric_reader("take_write_ms")(rec) == pytest.approx(150.0)
    assert metric_reader("restore_decode_ms")(rec) == pytest.approx(200.0)


def test_devtrace_union_gaps_and_labels():
    ann = "user_annotation"
    events = [
        {"ph": "X", "cat": ann, "name": "portbench.segment", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": ann, "name": "portbench.step", "ts": 0.0, "dur": 50.0},
        {"ph": "X", "cat": ann, "name": "portbench.take", "ts": 60.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 90.0, "dur": 20.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
    ]
    r = devtrace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 50] and [90, 100] (the copy clipped to the window)
    assert r["busy_s"] == pytest.approx(50e-6)
    assert r["kernels"]["k1"] == [1, pytest.approx(30e-6)]
    # idle: [0, 10] under step, [50, 90] (midpoint 70) under take
    assert r["idle_gaps"] == {"step": pytest.approx(10e-6), "take": pytest.approx(40e-6)}
    bd = devtrace.breakdown(r)
    assert bd["idle_gaps"][0][0] == "take" and len(bd["device_ops"]) == 3
