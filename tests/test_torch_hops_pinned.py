"""Where the port's pinned HOPS digest comes from.

``m3_tpu_torch.tools.hops.PINNED_VOLUME_SHA256`` (and ``chip_smoke.py``'s
copy, which phase 19 (a) holds the port's card volume against) must be
the digest of the volume that the JAX package's
``m3_tpu.tools.hops.run_pipeline(root=...)`` writes for the pinned corpus
(1,024 series x 320 s, seed 42).  This runs that pipeline at the pinned
corpus on the CPU (two passes, about 90 s each) and derives the digest.
It sits in a file of its own so that a parallel run gives it a worker
of its own.
"""

import m3_tpu.tools.hops as jhops
import m3_tpu_torch.tools.hops as thops


def test_pinned_digest_is_the_jax_pipelines_volume(tmp_path):
    doc = jhops.run_pipeline(root=str(tmp_path))
    assert doc["config"]["samples"] == jhops.S_DEFAULT * jhops.T_DEFAULT == 1024 * 320
    for p in ("cold", "steady"):
        assert thops.volume_digest(tmp_path / p) == thops.PINNED_VOLUME_SHA256, p
