"""bench.py's pure pieces — the variant grammar, the peak table and the
roofline refusal must stay locked, and the stdout line must stay compact."""

import importlib.util
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location("bench", os.path.join(REPO, "bench.py"))
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)

H100 = "NVIDIA H100 80GB HBM3"


def test_parse_variant_grammar():
    # (table_dtype, sorted, bf16buf, compact, delta)
    assert bench.parse_variant("float32") == ("float32", False, False, False, False)
    assert bench.parse_variant("float32+sorted") == ("float32", True, False, False, False)
    # delta implies sorted+compact
    assert bench.parse_variant("float32+delta") == ("float32", True, False, True, True)
    assert bench.parse_variant("int8+sorted+compact+delta") == (
        "int8", True, False, True, True)
    assert bench.parse_variant("float32+sorted+bf16buf")[2]


def test_variant_compute_dtype():
    assert bench.variant_compute_dtype("float32+sorted") == "float32"
    assert bench.variant_compute_dtype("float32+sorted+bf16compute") == "bfloat16"
    # must be a '+'-separated tag, not a substring of the dtype part
    assert bench.variant_compute_dtype("bf16compute") == "float32"


def test_roofline_refuses_impossible_numbers():
    peaks = bench.device_peaks(H100)
    model = bench.roofline_model(262144, "float32", wire_bytes=0.0)
    # 2e9 ex/s at ~3 KB/example implies ~6 TB/s, over the 3.35 TB/s peak
    with pytest.raises(RuntimeError, match="physically impossible"):
        bench.check_roofline(2_000_000_000, model, "test", peaks)
    out = bench.check_roofline(35_851_238, model, "test", peaks)
    assert out["implied_gb_per_sec"] < out["hbm_peak_gb_per_sec"]


def test_roofline_flop_bound_follows_compute_dtype():
    """f32 towers are bounded by the TF32 peak, bf16 towers by the bf16 peak."""
    peaks = bench.device_peaks(H100)
    model = {"bytes_per_example": 1.0, "flops_per_example": 1e6}
    eps = 700e6  # 700 TFLOP/s: over TF32's 495, under bf16's 989
    with pytest.raises(RuntimeError, match="physically impossible"):
        bench.check_roofline(eps, model, "f32", peaks, "float32")
    out = bench.check_roofline(eps, model, "bf16", peaks, "bfloat16")
    assert out["flops_peak_tflop_per_sec"] == 989.0


def test_device_peaks_h100_data_sheet():
    p = bench.device_peaks(H100)
    assert p == {"bf16_flops": 989e12, "tf32_flops": 495e12,
                 "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}


def test_roofline_records_the_card_beside_its_shares():
    """Shares are of 700 W data-sheet peaks; the card's own limit is kept."""
    card = "NVIDIA H100 80GB HBM3, 400.00 W"
    peaks = {**bench.device_peaks(H100), "card": card}
    model = bench.roofline_model(262144, "float32", wire_bytes=0.0)
    out = bench.check_roofline(35_851_238, model, "test", peaks)
    assert out["card"] == card
    assert out["peaks_at_power_limit_w"] == 700
    assert bench.check_roofline(35_851_238, model, "test",
                                bench.device_peaks(H100))["card"] is None


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A10", ""])
def test_device_peaks_refuses_unknown_kind(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks(kind)


def test_default_variant_list_parses():
    for spec_ in bench.DEFAULT_HOT_LOOP_VARIANTS.split(","):
        dt = bench.parse_variant(spec_)[0]
        assert dt in ("float32", "bfloat16", "int8")
        assert bench.variant_compute_dtype(spec_) in ("float32", "bfloat16")
    for spec_ in bench.DEFAULT_DEVICE_VARIANTS.values():
        assert bench.parse_variant(spec_)[0] in ("float32", "int8")


def test_compact_record_shape():
    """The stdout line stays compact: scalars and the device only, no window
    arrays or rooflines."""
    record = {
        "metric": "two_tower_train_examples_per_sec_1gpu",
        "value": 19940000.0, "unit": "examples/s", "vs_baseline": 738.5,
        "device": {"platform": "gpu", "kind": H100, "count": 1},
        "batch_size": 262144, "headline_dtype": "float32+sorted",
        "variants": {
            "float32+sorted": {
                "examples_per_sec": 19940000.0,
                "windows_examples_per_sec": [1.0] * 10,
                "window_losses": [0.7] * 10,
                "roofline": {"hbm_share_of_peak": 0.1},
            },
        },
        "device_step": {"examples_per_sec": 23220000.0, "step_ms": 11.3,
                        "batch_size": 262144, "losses": [1.0] * 12},
        "device_step_softmax": {"examples_per_sec": 2000000.0,
                                "step_ms": 32.0, "batch_size": 65536},
        "from_disk": {"examples_per_sec": 12000000.0,
                      "wire_cache": {"examples_per_sec": 15000000.0}},
    }
    out = bench.compact_record(record)
    line = json.dumps(out)
    assert len(line) < 2000, len(line)
    assert out["value"] == 19940000.0
    assert out["device"]["kind"] == H100
    assert out["variants_examples_per_sec"]["float32+sorted"] == 19940000.0
    assert out["device_step_softmax"]["batch_size"] == 65536
    assert "batch_size" not in out["device_step"]  # same as headline bs
    assert out["wire_cache_examples_per_sec"] == 15000000.0
    assert "windows_examples_per_sec" not in line
    assert "roofline" not in line
