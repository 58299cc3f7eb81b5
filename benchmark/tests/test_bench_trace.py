"""The trace arithmetic on synthetic intervals: the busy union (each
kernel adds what lies past the end of every one before it), the idle
gaps and their labels, the kinds by name."""

from harness import trace


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert abs(trace.union_busy(iv) - 26e-6) < 1e-12
    assert trace.union_busy([]) == 0.0


def test_idle_gaps():
    iv = [(5, 10), (8, 12), (20, 30)]
    assert trace.idle_gaps(iv, 0, 40) == [(0, 5), (12, 20), (30, 40)]
    assert trace.idle_gaps(iv, 5, 30) == [(12, 20)]


def test_gap_labels_follow_the_phases():
    items = [(0.0, 1e6), (1e6, 3e6)]
    phases = [[("encode", 0.25), ("generate", 0.75)], [("step", 2.0)]]
    assert trace._label(1e5, items, phases) == "encode"
    assert trace._label(5e5, items, phases) == "generate"
    assert trace._label(2e6, items, phases) == "step"
    assert trace._label(5e6, items, phases) == "between"


def test_kinds():
    assert trace.kind_of("nvjet_tst_128x32") == "gemm"
    assert trace.kind_of("prefix_flash_dq_kernel") == "prefix_flash"
    assert trace.kind_of("void at::native::elementwise_kernel<direct_copy>") \
        == "copy/cast"
    assert trace.kind_of("Memcpy HtoD") == "copy/cast"
    assert trace.kind_of("w4_prefill_kernel") == "other"
