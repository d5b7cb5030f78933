"""x/costwatch and x/optext: the port's stage registry, its census and
the grammar it classes dispatches with, held against the JAX package's
x/costwatch (the canonical shapes, every reference stage mapped) and its
ratchet (the same verdicts on the same synthetic artifacts).

Everything here is exact: counts are compared with ``==``; the ratchet
cases use the reference's 5 % tolerance on byte metrics.  The full
registry's artifact is built in tests/test_torch_costs.py."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from m3_tpu.tools import costs as ref_costs
from m3_tpu.x import costwatch as ref_cw
from m3_tpu_torch.parallel import decode_gather, encode_place
from m3_tpu_torch.parallel import segment_ingest as si
from m3_tpu_torch.tools import costs
from m3_tpu_torch.x import costwatch as cw
from m3_tpu_torch.x import devseams, optext


# ---------------------------------------------------------------------------
# The registry against the reference's
# ---------------------------------------------------------------------------


def test_canonical_shapes_are_the_references():
    assert cw.CANONICAL == ref_cw.CANONICAL


def test_stage_map_covers_every_reference_stage():
    ref = set(ref_cw.stage_names())
    assert set(cw.STAGE_MAP) == ref
    # every port stage stands for at least one reference stage
    assert set(cw.STAGE_MAP.values()) == set(cw.stage_names())
    assert cw.STAGE_MAP["decode/gather_pallas"] == cw.STAGE_MAP["decode/gather"] \
        == "decode/gather"
    assert {cw.STAGE_MAP[f"encode/{t}"] for t in ("gather", "scatter", "pallas")} \
        == {"encode"}


def test_stage_kernel_table_names_registered_stages_and_kernels():
    kernels = {encode_place.KERNEL, decode_gather.KERNEL, *si.KERNELS}
    assert set(cw.STAGE_KERNELS) <= set(cw.stage_names())
    for stage, ks in cw.STAGE_KERNELS.items():
        assert ks and set(ks) <= kernels, stage
    # all four kernels lie on the registry's path
    assert {k for ks in cw.STAGE_KERNELS.values() for k in ks} == kernels


def test_gated_metrics_are_the_census_fields():
    assert set(cw.EXACT_METRICS) < set(cw.GATED_METRICS)
    assert {f"ops.{c}" for c in optext.OP_CLASSES} <= set(cw.EXACT_METRICS)
    # no XLA cost-model field is faked
    assert not {"flops", "transcendentals", "bytes_accessed"} & set(cw.GATED_METRICS)


def test_unknown_stage_raises_before_any_run():
    with pytest.raises(KeyError, match="unknown costwatch stage"):
        cw.run_stages(["no/such_stage"], device="cpu")


def test_stage_cache_runs_a_stage_once():
    a = cw.counted_stage("arena/gauge_consume_f64", "cpu")
    assert cw.counted_stage("arena/gauge_consume_f64", "cpu") is a


# ---------------------------------------------------------------------------
# The ratchet's mechanics: the reference's verdicts on the same synthetic
# artifacts (tests/test_costwatch.py TestCheckGateMechanics), over the
# metrics both packages gate
# ---------------------------------------------------------------------------

# the port's names of the reference's violation kinds
_KIND = {"torch-version": "jax-version"}


def _mini(stage_fp: dict, platform: str = "cpu", version: str = "v1") -> dict:
    return {"artifact": "COSTS", "schema": costs.SCHEMA,
            "config": {"platform": platform, "jax": version, "torch": version},
            "stages": {"stage/x": stage_fp}}


def _fp(arg=2000, outb=500, peak=7500, cfg=None) -> dict:
    return {"datapoints": 100,
            "memory": {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": 0,
                       "alias_bytes": 0, "peak_bytes": peak},
            "config": dict(cfg or {"S": 1})}


def _no_stages(a):
    a["stages"] = {}
    return a


def _schema_plus_one(a):
    a["schema"] = costs.SCHEMA + 1
    return a


def _canon(a, s):
    a["config"]["canonical"] = {"S": s}
    return a


MECHANICS = {
    "identical_passes": (_mini(_fp()), _mini(_fp())),
    "within_tolerance_passes": (_mini(_fp(arg=2080)), _mini(_fp(arg=2000))),
    "regression_past_tolerance_fails": (_mini(_fp(outb=600)), _mini(_fp(outb=500))),
    "improvement_past_tolerance_fails": (_mini(_fp(peak=6000)), _mini(_fp(peak=7500))),
    "stage_vanished_fails": (_no_stages(_mini(_fp())), _mini(_fp())),
    "new_stage_fails": (_mini(_fp()), _no_stages(_mini(_fp()))),
    "config_change_fails_before_metrics": (_mini(_fp(arg=9999, cfg={"S": 2})),
                                           _mini(_fp(cfg={"S": 1}))),
    "platform_mismatch_refused": (_mini(_fp(), platform="cuda"), _mini(_fp())),
    "schema_mismatch_refused": (_mini(_fp()), _schema_plus_one(_mini(_fp()))),
    "version_mismatch_refused": (_mini(_fp(arg=5000), version="v2"), _mini(_fp())),
    "canonical_geometry_change_refused": (_canon(_mini(_fp()), 128),
                                          _canon(_mini(_fp()), 256)),
    "metric_appearing_from_zero_fails": (_mini(_fp(outb=100)), _mini(_fp(outb=0))),
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_ratchet_gives_the_references_verdicts(case):
    cur, base = MECHANICS[case]
    ours = costs.check_artifact(cur, base, tolerance=0.05)
    ref = ref_costs.check_artifact(cur, base, tolerance=0.05)
    assert [_KIND.get(e["kind"], e["kind"]) for e in ours] == [e["kind"] for e in ref]
    assert [e.get("metric") for e in ours] == [e.get("metric") for e in ref]
    if ours and ours[0]["kind"] == "improvement":
        assert "re-baseline" in ours[0]["message"]


@pytest.mark.parametrize("key,kind", [("device_name", "device"), ("cuda", "cuda-version")])
def test_ratchet_refuses_across_card_and_cuda(key, kind):
    base, cur = _mini(_fp()), _mini(_fp(arg=9000))
    base["config"][key], cur["config"][key] = "a", "b"
    assert [e["kind"] for e in costs.check_artifact(cur, base)] == [kind]


@pytest.mark.parametrize("metric", ["dispatches", "width64", "ops.scatter",
                                    "transfers.uploads", "kernel_grids"])
def test_counts_gate_exactly(metric):
    def fp(n):
        f = _fp()
        head, _, leaf = metric.rpartition(".")
        (f.setdefault(head, {}) if head else f)[leaf] = n
        return f

    assert costs.check_artifact(_mini(fp(1000)), _mini(fp(1000))) == []
    errs = costs.check_artifact(_mini(fp(1001)), _mini(fp(1000)), tolerance=0.05)
    assert [(e["kind"], e["metric"]) for e in errs] == [("regression", metric)]
    errs = costs.check_artifact(_mini(fp(999)), _mini(fp(1000)), tolerance=0.05)
    assert [(e["kind"], e["metric"]) for e in errs] == [("improvement", metric)]


# ---------------------------------------------------------------------------
# x/optext: the grammar and the classes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,parsed", [
    ("aten::add", ("aten", "add", False)),
    ("aten::add_", ("aten", "add", True)),
    ("aten::_to_copy", ("aten", "_to_copy", False)),
    ("aten::_index_put_impl_", ("aten", "_index_put_impl", True)),
    ("aten::__lshift__", ("aten", "__lshift__", False)),
    ("aten::__ilshift__", ("aten", "__ilshift__", False)),
    ("aten::_unique2", ("aten", "_unique2", False)),
    ("prim::device", ("prim", "device", False)),
])
def test_op_grammar(name, parsed):
    assert optext.parse_op(name) == parsed


@pytest.mark.parametrize("bad", ["add", "aten::", "aten.add.Tensor", "::add"])
def test_op_grammar_rejects(bad):
    with pytest.raises(ValueError):
        optext.parse_op(bad)


@pytest.mark.parametrize("name,cls", [
    ("aten::scatter_add_", "scatter"), ("aten::index_put_", "scatter"),
    ("aten::_index_put_impl_", "scatter"), ("aten::gather", "gather"),
    ("aten::index", "gather"), ("aten::nonzero", "gather"),
    ("aten::cumsum", "reduction"), ("aten::sum", "reduction"), ("aten::sort", "reduction"),
    ("aten::_to_copy", "copy"), ("aten::copy_", "copy"), ("aten::cat", "copy"),
    ("aten::_local_scalar_dense", "copy"), ("aten::zeros", "factory"),
    ("aten::empty", "factory"), ("aten::arange", "factory"), ("aten::where", "elementwise"),
    ("aten::bitwise_and", "elementwise"), ("aten::__rshift__", "elementwise"),
    ("aten::fill_", "elementwise"), ("aten::no_such_op", "other"),
])
def test_op_classes(name, cls):
    assert optext.op_class(name) == cls


def test_seams_histogram_and_censuses():
    assert optext.parse_seam("dispatch:kernel:place_words") == ("dispatch",
                                                                "kernel:place_words")
    assert optext.parse_seam("h2d:torch.as_tensor") == ("h2d", "torch.as_tensor")
    with pytest.raises(ValueError):
        optext.parse_seam("upload:x")
    hist = optext.op_histogram({"aten::add": 3, "aten::scatter_": 2, "aten::foo": 1})
    assert list(hist) == list(optext.OP_CLASSES)
    assert (hist["elementwise"], hist["scatter"], hist["other"], hist["copy"]) == (3, 2, 1, 0)
    assert optext.op_histogram(["aten::add", "aten::add"])["elementwise"] == 2
    types = optext.type_census({"int64": 3, "bool": 2, "float64": 1, "int32": 5})
    assert list(types) == ["bool", "float64", "int32", "int64"]
    assert optext.wide_count(types) == 4
    assert optext.kernel_census({"dispatch:kernel:place_words": [2, 0],
                                 "dispatch:aten::add": [9, 0],
                                 "h2d:torch.tensor": [1, 8]}) == {"place_words": 2}
    assert optext.uploaded_constants([("a", 10), ("b", 1 << 20), ("c", 1 << 16)],
                                     1 << 16) == [{"seam": "b", "bytes": 1 << 20},
                                                  {"seam": "c", "bytes": 1 << 16}]


# ---------------------------------------------------------------------------
# The census: what it counts, where, and the one home of the step counter
# ---------------------------------------------------------------------------


def test_census_counts_ops_on_the_cpu_but_no_views():
    a = torch.arange(8, dtype=torch.int64)
    with cw.census() as c:
        b = a + 1           # one op
        v = b.view(2, 4)    # a view: not an op
        s = v.sum()         # one op
        _ = (b.to(torch.int32) << 2).float()  # three ops
    assert int(s) == 36
    assert c.dispatches == 5
    hist = optext.op_histogram(c.ops)
    assert (hist["elementwise"], hist["reduction"], hist["copy"]) == (2, 1, 2)
    assert c.types == {"int64": 2, "int32": 2, "float32": 1}
    assert c.op_output_bytes == 8 * 8 + 8 + 4 * 8 * 2 + 4 * 8
    assert cw._on_op not in devseams.OPS and cw._on_count not in devseams.COUNTERS


def test_census_counts_its_own_thread_only():
    a = torch.ones(4)
    other = threading.Thread(target=lambda: [a + 1 for _ in range(10)])
    with cw.census() as c:
        other.start()
        other.join()
        a * 2
    assert c.dispatches == 1


def test_census_counts_uploads_and_kernel_launches():
    """On the meta device (the CPU's stand-in for a card): a factory
    upload and a hand kernel's launch hook."""
    with cw.census() as c:
        torch.as_tensor(np.arange(1 << 14, dtype=np.int64), device="meta")
        devseams.launched("place_words", 1)
        devseams.launched("segment_ingest", 5)
    s = c.summary()
    assert s["transfers"] == {"uploads": 1, "upload_bytes": 8 << 14, "downloads": 0,
                              "download_bytes": 0}
    assert s["constants"] == [{"seam": "torch.as_tensor", "bytes": 8 << 14}]
    assert s["kernels"] == {"place_words": {"launches": 1, "grids": 1},
                            "segment_ingest": {"launches": 1, "grids": 5}}
    assert (s["kernel_launches"], s["kernel_grids"]) == (2, 6)


def test_fingerprint_of_a_call():
    state = torch.zeros(16, dtype=torch.float64)
    idx = torch.arange(8) % 4

    def fn(st, i):
        st.index_add_(0, i, torch.ones(8, dtype=torch.float64))
        return st, i.to(torch.int32)

    fp = cw.fingerprint_call(fn, (state, idx), datapoints=8, device="cpu")
    assert fp["dispatches"] == 3  # ones, index_add_, _to_copy; the warm-up is not counted
    assert fp["ops"]["scatter"] == 1
    assert fp["memory"] == {"argument_bytes": 16 * 8 + 8 * 8, "output_bytes": 8 * 4,
                            "alias_bytes": 16 * 8, "peak_bytes": None}
    assert fp["peak_bytes_per_dp"] is None
    assert fp["dispatches_per_dp"] == pytest.approx(3 / 8)
    assert float(state.sum()) == 16.0  # the warm-up and the counted call


def test_count_step_ops_is_the_profile_harness_counter():
    from m3_tpu_torch.tools import decode_profile

    x = torch.arange(4)
    assert cw.count_step_ops(lambda: x * x + 1) == 2
    assert decode_profile._count_ops(lambda: x * x + 1) == 2


def test_platform_config_pins_the_cpu():
    assert cw.platform_config("cpu") == {"platform": "cpu", "device_name": "cpu",
                                         "torch": torch.__version__, "cuda": None}


def test_uncounted_scope_hides_a_checkers_work():
    a = torch.ones(4)
    with cw.census() as c:
        a + 1
        with cw.uncounted():
            a * 2
            devseams.launched("place_words", 1)
        a - 1
    assert c.dispatches == 2 and not c.kernels


def test_counting_tells_a_counted_run_apart():
    assert not cw.counting()
    with cw.census():
        assert cw.counting()
        with cw.uncounted():
            assert not cw.counting()
        assert cw.counting()
    assert not cw.counting()
