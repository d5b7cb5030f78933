"""Series-sharded M3TSZ encode over a list of devices: the counterpart
of ``m3_tpu/parallel/sharded_encode.py``.

The two-phase encode is parallel across the series axis: each device
encodes its own block of series with ``encode_batch_device`` (phase 2's
placement is kernel #1 on a card), and the blocks' outputs are gathered
to the first device.  Each block runs the same per-series program, so
the outputs equal the one-device encode's bit for bit.  A series count
that does not divide the device count is zero-padded; the padded rows
are all invalid, emit nothing and are sliced off.

The sharded dispatch is one call of ``x.devguard``'s ``encode`` stage
(each shard runs the codec's unguarded pass), as the reference guards
its sharded program.  Unlike the reference, nothing falls back: the JAX
package steps down to another placement on a device fault, while the
port has one placement (kernel #1) and a failure raises typed.
"""

from __future__ import annotations

import torch

from m3_tpu_torch.encoding import m3tsz_torch as codec
from m3_tpu_torch.parallel import mesh
from m3_tpu_torch.x import devguard


def _pad_rows(x, pad: int):
    """``x`` with ``pad`` zero rows appended along its first axis."""
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def encode_batch_device_sharded(timestamps, value_bits, start, valid, unit: int = 1,
                                out_words: int = 0, prefix_bits=None, place: str = "auto",
                                devices=None):
    """``encode_batch_device`` with the series axis split over
    ``devices`` (None = every visible CUDA card): the same contract and
    the same outputs, on the first device.  One device takes the
    one-device path.  ``place`` is accepted as ``"auto"`` only: the port
    has one placement, kernel #1."""
    if place != "auto":
        raise ValueError(f"place={place!r}: the port has one placement (kernel #1); "
                         "expected 'auto'")
    devs = [row[0] for row in mesh.make_mesh(devices=devices).devices]
    ts = torch.as_tensor(timestamps, dtype=torch.int64)
    S, T = ts.shape
    n_dev = min(len(devs), max(S, 1))
    if n_dev <= 1:
        return codec.encode_batch_device(timestamps, value_bits, start, valid, unit=unit,
                                         out_words=out_words, prefix_bits=prefix_bits,
                                         device=devs[0])
    if out_words == 0:
        out_words = (T * 16) // 64 + 4  # the codec's own default
    args = [ts, torch.as_tensor(value_bits, dtype=torch.int64),
            torch.as_tensor(start, dtype=torch.int64),
            torch.as_tensor(valid, dtype=torch.bool)]
    if prefix_bits is not None:
        args.append(torch.as_tensor(prefix_bits, dtype=torch.int32))
    pad = (-S) % n_dev
    if pad:
        args = [_pad_rows(a, pad) for a in args]
    step = (S + pad) // n_dev
    topo = mesh.make_mesh(devices=devs[:n_dev])
    blocks = [mesh.split(topo, a.reshape((n_dev, step) + tuple(a.shape[1:]))) for a in args]

    def local(ts, vb, st, va, pb=None):
        return codec._encode_batch_device(ts, vb, st, va, unit=unit, out_words=out_words,
                                          prefix_bits=pb, device=ts.device)

    def run():
        outs = mesh.run(topo, local, *blocks)
        return {k: torch.cat([row[0][k].to(topo.first) for row in outs])
                for k in ("words", "total_bits", "fallback")}

    out = devguard.run_guarded("encode", run)
    if pad:
        out = {k: v[:S] for k, v in out.items()}
    return out
