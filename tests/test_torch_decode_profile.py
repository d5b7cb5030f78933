"""tools/decode_profile: the port's codec profile, held against the JAX
package's decode_profile on the same streams (the captured per-step
cursor advances equal ``_capture_cursors``'s exactly), with its layers
nesting in dispatches (carry <= reads <= full; carry <= classify <=
phase1 <= prefix_frags <= full), its proxies replaying the true cursor
walk, and its report's keys.  Timings are not asserted (a CPU run
measures nothing of the card)."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from m3_tpu_torch import native
from m3_tpu_torch.encoding import m3tsz_torch as mt
from m3_tpu_torch.tools import decode_profile as dp
from m3_tpu_torch.x import costwatch as cw

S, T = 16, 24
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref_profile():
    """The JAX package's profile module.  Importing it pins the CPU device
    count, which raises once the backend is up; the test process already
    has its devices, so that pin is skipped for the import."""
    mod = sys.modules.get("m3_tpu.tools.decode_profile")
    if mod is None:
        from m3_tpu.parallel import mesh

        orig = mesh.enable_cpu_core_devices
        mesh.enable_cpu_core_devices = lambda n=None: None
        try:
            from m3_tpu.tools import decode_profile as mod
        finally:
            mesh.enable_cpu_core_devices = orig
    return mod


@pytest.fixture(scope="module")
def packed():
    return dp.encoded(*cw.bench_corpus(S, T), CPU)


def test_captured_cursors_equal_the_references(ref_profile, packed):
    import jax.numpy as jnp

    from m3_tpu.encoding import m3tsz_jax as mj

    words, nbits = packed
    ours = dp.capture_cursors(words, nbits, T + 1).numpy()
    ref = np.asarray(ref_profile._capture_cursors(
        jnp.asarray(words.numpy().view(np.uint64)), jnp.asarray(nbits.numpy()),
        mj.value_ctrl_table(), max_points=T + 1))
    assert ours.shape == ref.shape == (T + 1, S)
    assert np.array_equal(ours, ref.astype(np.int64))
    adv = np.diff(np.concatenate([np.zeros((1, S), np.int64), ours]), axis=0)
    ref_adv = np.diff(np.concatenate([np.zeros((1, S), ref.dtype), ref]), axis=0)
    assert np.array_equal(adv, ref_adv.astype(np.int64))
    # every stream ends at its own length's EOS
    assert (ours[-1] <= nbits.numpy()).all() and (ours[-1] > 64).all()


@pytest.mark.parametrize("mode", ["carry", "reads"])
def test_decode_proxies_replay_the_true_cursor_walk(packed, mode):
    words, nbits = packed
    cursors = dp.capture_cursors(words, nbits, T + 1)
    adv = torch.diff(cursors, dim=0, prepend=torch.zeros_like(cursors[:1]))
    wpad, _, _ = dp._prep(words, nbits)
    end, _ = dp.proxy_decode(wpad, adv, mt.value_ctrl_table(CPU), mode)
    assert torch.equal(end, cursors[-1])


def test_decode_layers_nest_in_dispatches(packed):
    words, nbits = packed
    cursors = dp.capture_cursors(words, nbits, T + 1)
    adv = torch.diff(cursors, dim=0, prepend=torch.zeros_like(cursors[:1]))
    wpad, _, _ = dp._prep(words, nbits)
    tbl = mt.value_ctrl_table(CPU)
    n = {m: cw.count_step_ops(dp.proxy_decode, wpad, adv, tbl, m) for m in ("carry", "reads")}
    n["full"] = cw.count_step_ops(mt._decode_batch_device, words, nbits, T + 1, device=CPU,
                                  chains="gather", scan_major=True)
    assert 0 < n["carry"] < n["reads"] < n["full"], n


def test_encode_layers_nest_in_dispatches():
    args = dp._encode_inputs(cw.bench_corpus(S, T), CPU)
    n = {m: cw.count_step_ops(dp.proxy_encode, *args, m)
         for m in ("carry", "classify", "phase1", "prefix_frags")}
    n["full"] = cw.count_step_ops(mt._encode_batch_device, *args, out_words=T * 40 // 64 + 8,
                                  device=CPU)
    order = ["carry", "classify", "phase1", "prefix_frags", "full"]
    assert all(0 < n[a] < n[b] for a, b in zip(order, order[1:])), n


def test_profile_decode_report(packed):
    out = dp.profile(S, T, CPU, packed=packed, reps=1)
    assert {"carry", "reads", "full", "gather_tail", "full_series_major",
            "full_fused_tail"} <= set(out["seconds"])
    assert set(out["attribution_s"]) == {"scan_carry_roundtrip", "bit_read_funnels",
                                         "parse_arithmetic_and_outputs"}
    per = out["dispatches_per_step"]
    assert per["carry"] <= per["reads"] <= per["full"]
    assert per["full"] >= out["step_ops"] == out["element_ops_per_datapoint"]
    assert abs(out["step_ops"] / cw.DOCUMENTED_OPS_PER_DP["decode_step"] - 1) <= 0.1
    # the reference-only keys are gone; the native yardstick is there
    assert not {"old_r05_single_scan", "vs_old_r05", "full_1device",
                "element_ops_r05"} & (set(out) | set(out["dps"]))
    assert native.available() and out["native_cpp_dps"] > 0


def test_profile_encode_report_and_kept_streams():
    keep: dict = {}
    corpus = cw.bench_corpus(S, T)
    out = dp.profile_encode(S, T, CPU, corpus=corpus, reps=1, keep=keep)
    assert set(out["attribution_s"]) == {
        "scan_carry_roundtrip", "classify_decimal_search", "lane_emission_rest_of_step",
        "prefix_sum_and_fragments", "word_placement"}
    per = out["dispatches_per_step"]
    assert per["carry"] < per["classify"] < per["phase1"] == per["prefix_frags"] \
        == per["full"]
    assert out["dispatches_fixed"]["prefix_frags"] < out["dispatches_fixed"]["full"]
    assert out["classify_ops"] < out["step_ops"]
    assert not {"old_r07_wide_carry_scan", "vs_old_r07", "element_ops_r07_wide_carry",
                "compile_s", "full_1device"} & (set(out) | set(out["dps"]))
    assert native.available() and out["native_cpp_dps"] > 0
    words, nbits = keep["packed"]
    ts, payload, meta, err, prec, ann = mt.decode_batch_device(words, nbits, T + 1,
                                                               device=CPU)
    assert not err.any()
    assert np.array_equal(ts[:, :T].numpy(), corpus[0])
    vals = mt.payload_value_bits(payload[:, :T].numpy().view(np.uint64), meta[:, :T].numpy())
    assert np.array_equal(vals.view(np.float64), corpus[1])


def test_streams_of_packed_words_are_the_encoded_streams(packed):
    """The native decode in ``profile`` reads the byte streams behind the
    packed words: they are the streams ``pack_streams`` was given."""
    ts, vals, starts = cw.bench_corpus(S, T)
    streams, fallback = native.encode_batch(ts, vals, starts)
    assert not fallback.any()
    assert dp._streams_of(*packed) == streams
