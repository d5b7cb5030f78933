"""Series-sharded M3TSZ decode over a list of devices: the counterpart
of ``m3_tpu/parallel/sharded_decode.py``.

The decode's bit-boundary scan is per series, so each device decodes its
own block of streams with ``decode_batch_device`` (on the ``gather``
tail, phase 2's field extraction is kernel #2 on a card) and the blocks'
outputs are gathered to the first device: bit for bit the one-device
decode's.  A stream count that does not divide the device count is
zero-padded; the padded rows decode as errors and are sliced off.

The sharded dispatch is one call of ``x.devguard``'s ``decode`` stage
(each shard runs the codec's unguarded pass), as the reference guards
its sharded program.  Unlike the reference, nothing falls back: the JAX
package steps down to the other chains tail on a device fault, while
here a failure raises typed.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.encoding import m3tsz_torch as codec
from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.x import devguard


def decode_batch_device_sharded(words, nbits, max_points: int, default_unit: int = 1,
                                chains: str = "auto", scan_major: bool = False,
                                devices=None):
    """``decode_batch_device`` with the stream axis split over
    ``devices`` (None = every visible CUDA card): the same contract and
    the same outputs, on the first device.  One device takes the
    one-device path."""
    chains = codec.resolved_chains(chains)
    devs = [row[0] for row in mesh.make_mesh(devices=devices).devices]
    words = torch.as_tensor(words, dtype=torch.int64)
    nbits = torch.as_tensor(nbits, dtype=torch.int64)
    S = words.shape[0]
    n_dev = min(len(devs), max(S, 1))
    if n_dev <= 1:
        return codec.decode_batch_device(words, nbits, max_points, default_unit=default_unit,
                                         device=devs[0], chains=chains, scan_major=scan_major)
    pad = (-S) % n_dev
    if pad:
        words = torch.cat([words, words.new_zeros((pad, words.shape[1]))])
        nbits = torch.cat([nbits, nbits.new_zeros(pad)])
    step = (S + pad) // n_dev
    topo = mesh.make_mesh(devices=devs[:n_dev])

    def local(w, nb):
        return codec._decode_batch_device(w, nb, max_points, default_unit=default_unit,
                                          device=w.device, chains=chains,
                                          scan_major=scan_major)

    def run():
        outs = mesh.run(topo, local, mesh.split(topo, words.reshape(n_dev, step, -1)),
                        mesh.split(topo, nbits.reshape(n_dev, step)))
        lane_axis = 1 if scan_major else 0  # the series axis of ts, payload and meta
        return tuple(torch.cat([row[0][i].to(topo.first) for row in outs],
                               dim=lane_axis if i < 3 else 0) for i in range(6))

    out = devguard.run_guarded("decode", run)
    if pad:
        lanes = (slice(None), slice(None, S)) if scan_major else (slice(None, S),)
        out = tuple(o[lanes] for o in out[:3]) + tuple(o[:S] for o in out[3:])
    return out
