"""The port's host CM (CKMS) quantile stream
(``m3_tpu_torch/aggregator/quantile_cm.py``) against
``m3_tpu.aggregator.quantile_cm`` on seeded streams: every quantile, min
and max exactly equal (bit for bit), after each flush, over uniform,
duplicate-heavy, sorted ascending and descending, gamma and tiny streams,
several batch sizes, several eps, and adds after a flush."""

import numpy as np
import pytest

import m3_tpu.aggregator.quantile_cm as jcm
import m3_tpu_torch.aggregator.quantile_cm as tcm

QUANTILES = (0.1, 0.5, 0.9, 0.95, 0.99, 0.999)


def _streams():
    rng = np.random.default_rng(11)
    return {
        "uniform": rng.random(20_000),
        "duplicates": rng.integers(0, 7, 12_000).astype(np.float64),
        "ascending": np.arange(8_000, dtype=np.float64),
        "descending": np.arange(8_000, 0, -1, dtype=np.float64),
        "gamma": rng.gamma(2.0, 0.05, 15_000),
        "tiny": np.asarray([3.5, -1.0, 2.25]),
    }


def _run(mod, values, batch, eps):
    st = mod.Stream(QUANTILES, eps=eps)
    out = []
    for lo in range(0, len(values), batch):
        st.add_batch([float(v) for v in values[lo:lo + batch]])
        if lo // batch == 1:
            st.flush()
            out.append([st.quantile(q) for q in QUANTILES] + [st.min(), st.max()])
    for v in values[:50]:
        st.add(float(v) * 0.5)
    st.flush()
    out.append([st.quantile(q) for q in QUANTILES] + [st.min(), st.max()])
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
@pytest.mark.parametrize("name", sorted(_streams()))
def test_cm_stream_matches_jax(name, eps):
    values = _streams()[name]
    for batch in (1, 997, 4096):
        if batch == 1 and values.size > 3000:
            continue
        j = _run(jcm, values, batch, eps)
        t = _run(tcm, values, batch, eps)
        assert np.array_equal(t.view(np.uint64), j.view(np.uint64)), (name, batch)


def test_defaults_match_jax():
    assert (tcm.DEFAULT_EPS, tcm.DEFAULT_INSERT_AND_COMPRESS_EVERY) == (
        jcm.DEFAULT_EPS, jcm.DEFAULT_INSERT_AND_COMPRESS_EVERY)
