"""irlint for the port: typed rules over the census of the stage registry
and over the per-hop ledger of the ingest → placement chain.  The
counterpart of ``m3_tpu/x/irlint.py``.

The reference lowers every registered stage and reads StableHLO and HLO
text.  The port runs eagerly and has no program text, so its rules read
what ``x/costwatch`` counts instead: each stage's ONE counted run per
device per process (``costwatch.counted_stages``, the cache
``tools/costs`` shares), classed by ``x/optext``.  Nothing here lowers,
parses or imports XLA.  Findings are lint-shaped (``lint.core.Finding``
keyed ``(rule, stage, message)``; line numbers mean nothing in a census)
under the same multiset ratchet as m3lint.

Rule families
-------------

* ``transfer-free``   — host syncs and transfers inside a stage's counted
  run: each host-syncing op by name (``optext.HOST_SYNC_OPS``:
  ``_local_scalar_dense``, ``nonzero``, ``masked_select``...; counted on
  the CPU as on the card) and, on the card, each other transfer seam
  (a copy to or from the host, a boolean-mask ``index``'s count).  The
  whitelist is empty: today's counts are committed findings in the
  baseline, each naming its op, and a new one fails.
* ``scatter-budget``  — ``ops.scatter`` per stage against
  :data:`SCATTER_BUDGETS`, measured from the CPU census (a plain version
  that becomes one kernel launch on the card only lowers the count).
* ``width-discipline`` — the stage's results by element type against
  its exact ceilings over int64 and float64 (u64 words travel as int64,
  ``_bits.py``): :data:`WIDTH_CONTRACTS` on the CPU, plus
  :data:`CARD_WIDTH_DELTAS` on the card; the codec stages forbid float64 outright
  (:data:`WIDE_FORBIDDEN`, the reference's), one finding per op that
  produces it.
* ``ir-const-bloat``  — per-call uploads of at least
  ``costwatch.CONSTANT_BYTES`` in a stage (``optext.uploaded_constants``;
  the reference's folded constants), less :data:`CONST_WHITELIST`'s
  reviewed entries, which the artifact records.
* ``residency-composition`` — the chain :data:`CHAIN` run on the device
  at :data:`PIPE`'s shapes through ``tools/hops.py``'s own ledger pass,
  with every transfer recorded beside the per-hop ledger (which it must
  equal, hop by hop, in count and bytes).  An array that crosses the
  host boundary at a seam is a finding (:class:`Crossing`); a seam with
  none is "composed".  There is no ``eval_shape`` in torch, so the proof
  is the count on a real pass.  Attribution, by the ledger's hops
  (``arena_ingest``, ``window_drain``, ``encode``):

  - ``arena_ingest → window_drain``: arrays ``arena_ingest`` downloads
    and arrays ``window_drain`` uploads (the arena state leaving and
    re-entering the device);
  - ``window_drain → encode_phase1``: arrays ``window_drain`` downloads
    (the drained lanes) and the encode's input uploads, made before its
    first device op;
  - ``encode_phase1 → placement``: any transfer inside the encode after
    its first device op and before kernel #1's launch (phase 1's lanes
    read back before the placement consumes them; on the CPU, where no
    kernel launches, the rest of the encode);
  - the chain's entry (``arena_ingest``'s uploads of the wire batches)
    and exit (the encode's downloads after the placement) are outside
    it and only recorded.

  One-element transfers and the host-syncing ops are recorded per seam
  as ``scalars`` (the stages' own syncs, ``transfer-free``'s class),
  not as crossings, except inside the encode where any transfer sits
  between phase 1 and the placement.  The record holds the ledger
  beside every hop and beside each of the first two seams (its
  producer hop's downloads and consumer hop's uploads): recorded and
  ledger must be equal (``ledger_equal``).  On the CPU nothing is a transfer
  (the port's stated difference), so every seam there is composed by
  construction; the CPU pass runs at :data:`CPU_PIPE`, cut to one
  window.

The artifact (:func:`build_artifact`) is pinned to
``costwatch.platform_config`` and :func:`check_artifact` refuses a
comparison across platforms, cards, torch or CUDA versions, or shapes,
as ``tools/costs`` does.  Baselines: ``tools/irlint_baseline_cpu.json``
(the CPU tests' gate) and ``tools/irlint_baseline_cuda.json`` (written
on the card, checked by ``chip_smoke.py`` phase 26).
"""

from __future__ import annotations

import json
import tempfile
import traceback
from pathlib import Path
from typing import Dict, List, NamedTuple

import torch

from m3_tpu_torch.x import optext
from m3_tpu_torch.x.lint.core import Finding, diff_baseline

__all__ = [
    "CHAIN", "CONST_WHITELIST", "CPU_PIPE", "Crossing", "EXPLAIN", "PIPE",
    "Program", "RULES", "SCATTER_BUDGETS", "SCHEMA", "SEAMS", "WIDE_FORBIDDEN",
    "WIDTH_CONTRACTS", "CARD_WIDTH_DELTAS", "analyze_program", "build_artifact",
    "check_against_baseline", "check_artifact", "default_baseline_path", "program",
    "residency_report", "width_contract",
]

SCHEMA = 1

RULES = ("transfer-free", "scatter-budget", "width-discipline",
         "ir-const-bloat", "residency-composition")

_HERE = Path(__file__).resolve().parents[1] / "tools"


def default_baseline_path(platform: str) -> Path:
    """The committed baseline of ``platform`` (``"cpu"`` or ``"cuda"``)."""
    return _HERE / f"irlint_baseline_{platform}.json"


# ---------------------------------------------------------------------------
# Contracts.  Every registered stage has a row in SCATTER_BUDGETS and
# WIDTH_CONTRACTS (tests hold the keys to costwatch.stage_names()); a
# program not in the tables gets the zero contract.  The numbers are the
# port's CPU census at costwatch's canonical shapes (the plain versions
# run there; on the card a plain version becomes one launch, which only
# lowers a scatter count; the width ceilings add the card's routes).
# ---------------------------------------------------------------------------

# Scatter-class ops a stage may dispatch (census > budget is a finding).
# The non-zero rows are the reviewed ones: the encode's placement (its
# plain version's scatter_add_; kernel #1 on the card), the f64 arenas'
# per-lane index_add_/index_put_ updates (kernels #3/#4's plain versions
# and the last-value writes), the packed layout's bounded promotions.
SCATTER_BUDGETS: Dict[str, int] = {
    "decode/fused": 0,
    "decode/gather": 0,
    "decode/sharded": 0,
    "encode": 1,
    "encode/sharded": 2,
    "arena/rollup_ingest_packed": 16,
    "arena/counter_ingest_f64": 6,
    "arena/gauge_ingest_f64": 8,
    "arena/counter_consume_packed": 0,
    "arena/counter_consume_f64": 0,
    "arena/gauge_consume_packed": 0,
    "arena/gauge_consume_f64": 0,
    "timer/ingest_packed": 2,
    "timer/ingest_f64": 6,
    "timer/consume_packed": 0,
    "timer/consume_f64": 0,
}

# 64-bit result ceilings per stage (int64 carries the u64 words): the
# CPU census exactly.  The codec's int64 budget is its design; the
# contract catches the census GROWING, the shape a silent promotion
# takes.  The card's ceilings are these plus CARD_WIDTH_DELTAS.
WIDTH_CONTRACTS: Dict[str, Dict[str, int]] = {
    "decode/fused": {"int64": 49316},
    "decode/gather": {"int64": 42059},
    "decode/sharded": {"int64": 84124},
    "encode": {"int64": 115739},
    "encode/sharded": {"int64": 231486},
    "arena/rollup_ingest_packed": {"int64": 656, "float64": 446},
    "arena/counter_ingest_f64": {"int64": 23},
    "arena/gauge_ingest_f64": {"int64": 60, "float64": 18},
    "arena/counter_consume_packed": {"int64": 26, "float64": 25},
    "arena/counter_consume_f64": {"int64": 3, "float64": 25},
    "arena/gauge_consume_packed": {"int64": 3, "float64": 20},
    "arena/gauge_consume_f64": {"int64": 3, "float64": 20},
    "timer/ingest_packed": {"int64": 34},
    "timer/ingest_f64": {"int64": 30, "float64": 9},
    "timer/consume_packed": {"int64": 39, "float64": 274},
    "timer/consume_f64": {"int64": 36, "float64": 41},
}

# The card's census less the CPU's, by route, not by promotion (phase 26
# (b) of chip_smoke.py accounts for every op of the difference): a hand
# kernel's launch replaces its plain version's 64-bit results (the
# negative rows; each codec stage's scan kernel replaces the whole loop of
# ``_decode_step`` or ``_encode_step``, and the decode's also the fused
# tail's upload of its unit table); the consume stages' ``arena._sqrt``
# is ``torch.sqrt`` on the card where the CPU takes numpy's correctly
# rounded root (no aten op).
CARD_WIDTH_DELTAS: Dict[str, Dict[str, int]] = {
    "decode/fused": {"int64": -49308},
    "decode/gather": {"int64": -40688},
    "decode/sharded": {"int64": -81376},
    "encode": {"int64": -115710},
    "encode/sharded": {"int64": -231420},
    "arena/counter_ingest_f64": {"int64": -19},
    "arena/gauge_ingest_f64": {"int64": -38, "float64": -13},
    "arena/counter_consume_packed": {"float64": 1},
    "arena/counter_consume_f64": {"float64": 1},
    "arena/gauge_consume_packed": {"float64": 1},
    "arena/gauge_consume_f64": {"float64": 1},
    "timer/ingest_f64": {"int64": -4, "float64": -7},
    "timer/consume_packed": {"float64": 1},
    "timer/consume_f64": {"float64": 1},
}

# Wide types a stage may not produce AT ALL: the codec is integer and
# bit ops end to end, so a float64 result there is an accidental float
# path through timestamps or value bits, not a budget question.
WIDE_FORBIDDEN: Dict[str, tuple] = {
    name: ("float64",) for name in WIDTH_CONTRACTS
    if name.startswith(("decode/", "encode"))
}

WIDE_TYPES = ("int64", "float64")


def width_contract(stage: str, platform: str) -> Dict[str, int]:
    """The 64-bit result ceilings of ``stage`` on ``platform``: the CPU
    census, plus the card's route deltas on ``"cuda"``; exact on both."""
    base = WIDTH_CONTRACTS.get(stage, {})
    delta = CARD_WIDTH_DELTAS.get(stage, {}) if platform == "cuda" else {}
    return {t: base.get(t, 0) + delta.get(t, 0) for t in WIDE_TYPES}


# (stage, seam, bytes) -> reviewed reason: an upload of at least
# CONSTANT_BYTES a stage may make every call.  The irlint analogue of an
# m3lint inline suppression; applied entries are recorded in the
# artifact's suppressions.  No stage uploads a table today.
CONST_WHITELIST: Dict[tuple, str] = {}


# ---------------------------------------------------------------------------
# Rule engines.  Each takes a Program (any object with .name, .device,
# .fingerprint and .records: a costwatch.CountedStage qualifies) and
# returns Findings keyed (rule, path=stage name, message), the messages
# built only from census counts and contract values.
# ---------------------------------------------------------------------------


class Program(NamedTuple):
    """One counted run's fingerprint and records, apart from the
    registry, so that tests can lint programs of their own."""

    name: str
    device: str
    fingerprint: dict
    records: dict


def program(name: str, fn, args: tuple, datapoints: int, device) -> Program:
    """Count ``fn(*args)`` on ``device`` as costwatch counts a stage (a
    warm-up, then one counted run) and return it as a :class:`Program`."""
    from m3_tpu_torch.x import costwatch

    fp, c = costwatch._fingerprint(fn, args, datapoints, device)
    return Program(name=name, device=str(torch.device(device)), fingerprint=fp,
                   records=c.records())


def _find(rule: str, path: str, message: str) -> Finding:
    return Finding(rule, path, 0, message)


def rule_transfer_free(p) -> List[Finding]:
    out: List[Finding] = []
    for op, n in optext.host_syncs(p.records["ops"]).items():
        out.append(_find(
            "transfer-free", p.name,
            f"host-syncing op {op} x{n} in a hot-path stage (a device->host "
            "read inside the stage, every call on the card)"))
    for key, (n, nbytes) in p.records["transfers"].items():
        kind, seam = optext.parse_seam(key)
        if seam.startswith("aten::") and optext.parse_op(seam)[1] in optext.HOST_SYNC_OPS:
            continue  # counted above, by name
        out.append(_find(
            "transfer-free", p.name,
            f"{kind} transfer {seam} x{n} ({nbytes} B) in a hot-path stage "
            "(the host whitelist is empty)"))
    return out


def rule_scatter_budget(p) -> List[Finding]:
    budget = SCATTER_BUDGETS.get(p.name, 0)
    n = p.fingerprint["ops"]["scatter"]
    if n <= budget:
        return []
    return [_find(
        "scatter-budget", p.name,
        f"scatter-class census {n} exceeds the stage budget {budget} (only "
        "reviewed bounded scatters are budgeted; everything else is 0)")]


def rule_width_discipline(p) -> List[Finding]:
    contract = width_contract(p.name, p.device.split(":")[0])
    forbidden = WIDE_FORBIDDEN.get(p.name, ())
    types = p.fingerprint["types"]
    out: List[Finding] = []
    for t in WIDE_TYPES:
        n = int(types.get(t, 0))
        if t in forbidden and n:
            for op, k in p.records["wide_results"].get(t, {}).items():
                out.append(_find(
                    "width-discipline", p.name,
                    f"forbidden wide type {t} from {op} x{k} (census {n}) — this "
                    f"stage's contract is no-{t} (codec bit-exactness is "
                    "integer/bit ops end to end)"))
            continue
        ceil = contract[t]
        if n > ceil:
            out.append(_find(
                "width-discipline", p.name,
                f"64-bit census {t} = {n} exceeds the declared width contract "
                f"{ceil} — a silent promotion (int32 to int64, float32 to "
                "float64) widens the census before it moves a byte metric"))
    return out


def rule_ir_const_bloat(p, whitelist=None):
    """(findings, suppressions): whitelisted uploads are reported as
    applied suppressions, never dropped silently."""
    from m3_tpu_torch.x import costwatch

    if whitelist is None:
        whitelist = CONST_WHITELIST
    out: List[Finding] = []
    sups: List[dict] = []
    for c in p.fingerprint["constants"]:
        reason = whitelist.get((p.name, c["seam"], c["bytes"]))
        if reason is not None:
            sups.append({"rule": "ir-const-bloat", "stage": p.name, "seam": c["seam"],
                         "bytes": c["bytes"], "reason": reason})
            continue
        out.append(_find(
            "ir-const-bloat", p.name,
            f"per-call upload {c['seam']} of {c['bytes']} B (>= "
            f"{costwatch.CONSTANT_BYTES}) in a stage — a table belongs in the "
            "stage's arguments, made once per device, or in CONST_WHITELIST "
            "with a reviewed reason"))
    return out, sups


def analyze_program(p):
    """The four census rules over one program: (findings, suppressions)."""
    findings = rule_transfer_free(p) + rule_scatter_budget(p) + rule_width_discipline(p)
    cb, sups = rule_ir_const_bloat(p)
    return findings + cb, sups


# ---------------------------------------------------------------------------
# Residency composition
# ---------------------------------------------------------------------------

# The tools/hops geometry the crossings are counted at (the reference's
# PIPE); CPU_PIPE is the CPU's cut (one window: nothing crosses there).
PIPE = {"S": 1024, "T": 320, "resolution_s": 10}
CPU_PIPE = {"S": 1024, "T": 10, "resolution_s": 10}

CHAIN = ("arena_ingest", "window_drain", "encode_phase1", "placement")
SEAMS = (
    ("arena_ingest->window_drain", "arena_ingest", "window_drain"),
    ("window_drain->encode_phase1", "window_drain", "encode_phase1"),
    ("encode_phase1->placement", "encode_phase1", "placement"),
)
# each seam's ends in the ledger, (producer hop, direction) and
# (consumer hop, direction); the encode's inner seam lies inside one hop
_SEAM_HOPS = ((("arena_ingest", "d2h"), ("window_drain", "h2d")),
              (("window_drain", "d2h"), ("encode", "h2d")),
              None)
_COPIES = ("aten::_to_copy", "aten::copy_")
_PLACEMENT = "kernel:place_words"
_OWN = ("/x/devseams.py", "/x/hopwatch.py", "/x/irlint.py", "/contextlib.py")


class Crossing(NamedTuple):
    """Arrays of one shape that cross the host boundary at a seam."""

    direction: str      # "d2h" | "h2d"
    name: str           # "<hop>.<op>"
    dtype: str
    shape: tuple
    bytes_each: int
    transfers: int      # in one pass
    via: str            # the port function that made the copy

    @property
    def total_bytes(self) -> int:
        return self.bytes_each * self.transfers

    @property
    def message(self) -> str:
        dims = "x".join(str(d) for d in self.shape) or "scalar"
        return (f"{self.direction} {self.name} {self.dtype}[{dims}] "
                f"{self.bytes_each}B x{self.transfers} = {self.total_bytes}B "
                f"via {self.via}")


def _via() -> str:
    """The innermost function on the stack outside torch and the
    instruments: the one that made the copy (a port path, or a file's
    name)."""
    for fr in reversed(traceback.extract_stack()):
        f = fr.filename.replace("\\", "/")
        if "/torch/" in f or f.endswith(_OWN):
            continue
        if "/m3_tpu_torch/" in f:
            return f"m3_tpu_torch/{f.rsplit('/m3_tpu_torch/', 1)[1]}:{fr.name}"
        return f"{f.rsplit('/', 1)[-1]}:{fr.name}"
    return "?"


class _Recorder:
    """Every transfer of a ledger pass with its hop and place in the
    encode (inputs, phase 1, placed), beside the ledger."""

    def __init__(self):
        from m3_tpu_torch.x import hopwatch

        self._hop = hopwatch.current_hop
        self.rows: list = []     # (hop, stage, direction, op, n, nbytes, scalar, key)
        self.vias: dict = {}     # group key -> via
        self._enc = "inputs"

    def on_count(self, kind, seam, n, nbytes) -> None:
        if kind != "dispatch" or self._hop() != "encode":
            return
        if seam == _PLACEMENT:
            self._enc = "placed"
        elif self._enc == "inputs" and seam not in _COPIES:
            self._enc = "phase1"

    def on_transfer(self, direction, seam, n, nbytes, t) -> None:
        hop = self._hop()
        scalar = (seam.startswith("aten::") and optext.parse_op(seam)[1]
                  in optext.HOST_SYNC_OPS | {"index", "index_put", "_index_put_impl"}
                  ) or nbytes <= t.element_size()
        key = (direction, f"{hop}.{seam}", str(t.dtype).removeprefix("torch."),
               tuple(int(d) for d in t.shape), int(nbytes))
        if key not in self.vias:
            self.vias[key] = _via()
        stage = self._enc if hop == "encode" else None
        self.rows.append((hop, stage, direction, seam, int(n), int(nbytes), scalar, key))


def _place(hop: str, stage, direction: str, scalar: bool) -> tuple:
    """(where, crossing) of one transfer: ``where`` a seam's name,
    ``entry``, ``exit`` or ``outside``; ``crossing`` whether it is one
    (see the module docstring)."""
    if hop == "arena_ingest":
        return ("entry", False) if direction == "h2d" else (SEAMS[0][0], not scalar)
    if hop == "window_drain":
        return (SEAMS[0][0] if direction == "h2d" else SEAMS[1][0]), not scalar
    if hop == "encode":
        if stage == "phase1":
            return SEAMS[2][0], True
        if stage == "inputs":
            return SEAMS[1][0], not scalar
        return "exit", False
    return "outside", False


def _ledger_pass(device, pipe: dict):
    """(recorder, per-hop ledger, samples): ``tools/hops``'s ledger pass
    at ``pipe``'s shapes, after one uncounted warm-up pass (the kernels'
    loads, the lazy inits), with every transfer recorded."""
    from m3_tpu_torch.tools import hops
    from m3_tpu_torch.x import devseams

    frames, policy, opts = hops.pipeline_inputs(pipe["S"], pipe["T"])
    rec = _Recorder()
    with tempfile.TemporaryDirectory() as tmp:
        hops._run_pass(frames, policy, opts, Path(tmp) / "warm", device)
        devseams.COUNTERS.append(rec.on_count)
        devseams.TRANSFERS.append(rec.on_transfer)
        try:
            ledger, _, n = hops.ledger_pass(frames, policy, opts, Path(tmp) / "pass", device)
        finally:
            devseams.COUNTERS.remove(rec.on_count)
            devseams.TRANSFERS.remove(rec.on_transfer)
    return rec, ledger, n


def residency_report(device=None, pipe: dict | None = None):
    """(findings, record) of one pass of the chain on ``device`` (None =
    CUDA) at ``pipe``'s shapes (default :data:`PIPE`): each seam's
    crossings (findings), scalars and ledger cross-check, and the chain's
    entry and exit."""
    from m3_tpu_torch import resolve_device

    dev = resolve_device(device)
    pipe = dict(PIPE if pipe is None else pipe)
    rec, ledger, samples = _ledger_pass(dev, pipe)
    places: Dict[str, dict] = {}
    groups: Dict[str, Dict[tuple, int]] = {}
    recorded: Dict[str, list] = {}
    for hop, stage, direction, seam, n, nbytes, scalar, key in rec.rows:
        row = recorded.setdefault(hop, [0, 0, 0, 0])
        i = 0 if direction == "h2d" else 2
        row[i] += n
        row[i + 1] += nbytes
        where, crossing = _place(hop, stage, direction, scalar)
        pl = places.setdefault(where, {"arrays": [0, 0], "scalars": [0, 0]})
        part = pl["scalars" if scalar and not crossing else "arrays"]
        part[0] += n
        part[1] += nbytes
        if crossing:
            g = groups.setdefault(where, {})
            g[key] = g.get(key, 0) + n
    hops_equal = {}
    for hop in sorted(set(ledger) | set(recorded)):
        st = ledger.get(hop, {})
        want = [st.get("h2d_count", 0), st.get("h2d_bytes", 0),
                st.get("d2h_count", 0), st.get("d2h_bytes", 0)]
        hops_equal[hop] = {"ledger": want, "recorded": recorded.get(hop, [0, 0, 0, 0])}
    findings: List[Finding] = []
    seams = []
    for (name, producer, consumer), hop_ends in zip(SEAMS, _SEAM_HOPS):
        crossings = [Crossing(direction=k[0], name=k[1], dtype=k[2], shape=k[3],
                              bytes_each=k[4], transfers=c, via=rec.vias[k])
                     for k, c in sorted(groups.get(name, {}).items())]
        for c in crossings:
            findings.append(_find("residency-composition", f"seam:{name}", c.message))
        pl = places.get(name, {"arrays": [0, 0], "scalars": [0, 0]})
        rec_seam = {
            "seam": name, "producer": producer, "consumer": consumer,
            "composed": not crossings,
            "crossings": [dict(c._asdict(), shape=list(c.shape)) for c in crossings],
            "transfers": pl["arrays"][0], "bytes": pl["arrays"][1],
            "scalars": {"transfers": pl["scalars"][0], "bytes": pl["scalars"][1]},
        }
        if hop_ends is not None:
            # the ledger's rows at the seam's ends: the producer hop's
            # downloads and the consumer hop's uploads
            (ph, pd), (ch, cd) = hop_ends
            got = [0, 0]
            for hop, d in ((ph, pd), (ch, cd)):
                st = ledger.get(hop, {})
                got[0] += st.get(f"{d}_count", 0)
                got[1] += st.get(f"{d}_bytes", 0)
            mine = [pl["arrays"][0] + pl["scalars"][0], pl["arrays"][1] + pl["scalars"][1]]
            rec_seam["ledger"] = {"transfers": got[0], "bytes": got[1],
                                  "equal": got == mine}
        seams.append(rec_seam)
    record = {
        "chain": list(CHAIN), "pipe": pipe, "samples": samples,
        "device": str(dev), "seams": seams,
        "entry": places.get("entry", {"arrays": [0, 0], "scalars": [0, 0]}),
        "exit": places.get("exit", {"arrays": [0, 0], "scalars": [0, 0]}),
        "outside": places.get("outside", {"arrays": [0, 0], "scalars": [0, 0]}),
        "hops": hops_equal,
        "ledger_equal": (all(v["ledger"] == v["recorded"] for v in hops_equal.values())
                         and all(s["ledger"]["equal"] for s in seams if "ledger" in s)),
    }
    return findings, record


# ---------------------------------------------------------------------------
# Artifact + ratchet
# ---------------------------------------------------------------------------


def build_artifact(device=None, stage_names=None, log=None) -> dict:
    """Lint the registry's censuses (or the named ``stage_names``: the
    residency pass always runs) and the chain's residency on ``device``
    (None = CUDA), at :data:`PIPE` (:data:`CPU_PIPE` on the CPU), and
    assemble the IRLINT document; ``log(msg)`` hears each stage's census
    wall.  The censuses come from costwatch's stage cache, so after a
    ``tools/costs`` build in the same process no stage runs again."""
    from m3_tpu_torch import resolve_device
    from m3_tpu_torch.x import costwatch

    dev = resolve_device(device)
    pipe = CPU_PIPE if dev.type == "cpu" else PIPE
    findings: List[Finding] = []
    suppressions: List[dict] = []
    on_stage = None if log is None else (
        lambda name, seconds: log(f"irlint: {name} counted in {seconds:.1f} s"))
    stages = costwatch.counted_stages(stage_names, device=dev, on_stage=on_stage)
    for cs in stages.values():
        f, s = analyze_program(cs)
        findings += f
        suppressions += s
    res_findings, residency = residency_report(dev, pipe)
    findings += res_findings
    counts = {rule: 0 for rule in RULES}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "artifact": "IRLINT",
        "schema": SCHEMA,
        "generated_by": "m3_tpu_torch.x.irlint.build_artifact",
        "config": dict(costwatch.platform_config(dev), canonical={
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in costwatch.CANONICAL.items()}, pipe=dict(pipe)),
        "rules": list(RULES),
        "stages": list(stages),
        "counts": counts,
        "findings": [{"rule": f.rule, "path": f.path, "message": f.message}
                     for f in sorted(findings)],
        "suppressions": suppressions,
        "const_whitelist": [{"stage": k[0], "seam": k[1], "bytes": k[2], "reason": v}
                            for k, v in sorted(CONST_WHITELIST.items())],
        "residency": residency,
    }


def _finding_objs(artifact: dict) -> List[Finding]:
    return [Finding(f["rule"], f["path"], 0, f["message"])
            for f in artifact.get("findings", [])]


def check_artifact(artifact: dict, baseline: dict) -> list:
    """The ratchet: typed refusals first (a comparison across a schema,
    platform, card, torch, CUDA or shape change would charge legitimate
    movement to a rule), then the multiset diff over finding keys: a new
    finding fails, and a stale baseline entry fails the other way (an
    improvement re-baselines, so the ratchet only tightens)."""
    errs: list = []

    def err(kind, msg, **extra):
        errs.append(dict({"kind": kind, "message": msg}, **extra))

    if baseline.get("schema") != artifact.get("schema"):
        err("schema", f"schema mismatch: baseline {baseline.get('schema')} vs "
            f"current {artifact.get('schema')} — regenerate the baseline")
        return errs
    for key, kind, why in (
            ("platform", "platform", "censuses only ratchet within one backend"),
            ("device_name", "device", "another card moves transfers and peaks"),
            ("torch", "torch-version", "a torch upgrade legitimately moves the "
             "op census; re-baseline in a change of its own"),
            ("cuda", "cuda-version", "a CUDA upgrade may move the census")):
        b = baseline.get("config", {}).get(key)
        c = artifact.get("config", {}).get(key)
        if b != c:
            err(kind, f"{key} mismatch: baseline {b!r} vs current {c!r} — {why}")
            return errs
    for key in ("canonical", "pipe"):
        b = baseline.get("config", {}).get(key)
        c = artifact.get("config", {}).get(key)
        if b != c:
            err("config", f"{key} geometry changed: baseline {b} vs current {c} — "
                "pinned shapes moved; re-baseline deliberately")
            return errs
    if set(baseline.get("stages", ())) != set(artifact.get("stages", ())):
        err("stages", f"stage set changed: baseline {sorted(baseline.get('stages', ()))}"
            f" vs current {sorted(artifact.get('stages', ()))}")
        return errs
    new, fixed = diff_baseline(_finding_objs(artifact), _finding_objs(baseline))
    for f in new:
        err("new-finding", f"[{f.rule}] {f.path}: {f.message}", rule=f.rule, path=f.path)
    for f in fixed:
        err("stale-baseline", f"[{f.rule}] {f.path}: baseline entry no longer fires "
            f"({f.message}) — commit the improvement: re-baseline", rule=f.rule,
            path=f.path)
    return errs


def check_against_baseline(artifact: dict, baseline_path) -> list:
    return check_artifact(artifact, json.loads(Path(baseline_path).read_text()))


def save_artifact(artifact: dict, path) -> None:
    """Write ``artifact`` as a baseline file (a re-baseline)."""
    Path(path).write_text(json.dumps(artifact, indent=1, sort_keys=True) + "\n")


# ---------------------------------------------------------------------------
# Rationale + examples
# ---------------------------------------------------------------------------

EXPLAIN = {
    "transfer-free": {
        "why": (
            "The hot path's contract is device-resident end to end: a "
            "scalar read, a data-dependent-shape op or a copy to the host "
            "inside a registered stage is a synchronous round trip every "
            "call on the card — the class hopwatch meters at run time, "
            "caught here from the stage's census with the host whitelist "
            "EMPTY.  Today's syncs are committed findings, each naming its "
            "op; a new one fails."),
        "bad": ("n = int(mask.sum())   # aten::_local_scalar_dense in a stage\n"
                "idx = mask.nonzero()  # a count copied to the host\n"),
        "good": ("keep shapes static: torch.where(mask, x, 0), or a bound "
                 "computed on the host before the stage\n"),
    },
    "scatter-budget": {
        "why": (
            "Writes at computed indices serialize on collisions and were "
            "designed out of the hot path: the survivors are the reviewed "
            "rows of SCATTER_BUDGETS (the placement's plain version, the "
            "f64 arenas' per-lane updates, the packed layout's bounded "
            "promotions).  Budgets are exact ceilings on the census."),
        "bad": ("state.index_add_(0, idx, v) creeping into a consume stage: "
                "scatter census 1 > budget 0\n"),
        "good": ("a dense or segmented formulation, a hand kernel, or a "
                 "reviewed budget row with the bound's reason\n"),
    },
    "width-discipline": {
        "why": (
            "A silent int32->int64 or float32->float64 promotion doubles a "
            "lane and shows in a byte metric only within tolerance.  Each "
            "stage declares its 64-bit result ceilings (int64 carries the "
            "u64 words); the codec stages forbid float64 outright — "
            "timestamps and value bits are integer and bit ops end to end, "
            "so every float64 result there names its op."),
        "bad": ("torch.cumsum(i32_lanes, 0)  # int64 by default: the census "
                "jumps past the ceiling\n"),
        "good": "torch.cumsum(i32_lanes, 0, dtype=torch.int32)\n",
    },
    "ir-const-bloat": {
        "why": (
            "A table converted inside a stage is uploaded every call on "
            "the card (the reference's constant folded into every "
            "compilation).  Uploads of at least CONSTANT_BYTES in a stage's "
            "run are findings unless CONST_WHITELIST records a reviewed "
            "reason, which the artifact repeats."),
        "bad": ("tbl = torch.as_tensor(_VALUE_CTRL_TBL, device=dev)  # every "
                "decode call\n"),
        "good": ("tbl = value_ctrl_table(dev)  # made once per device, passed "
                 "as an argument\n"),
    },
    "residency-composition": {
        "why": (
            "The chain arena_ingest -> window_drain -> encode phase 1 -> "
            "placement should keep its arrays on the card.  Its pass runs "
            "through tools/hops's ledger with every transfer recorded: an "
            "array crossing the host boundary at a seam is a finding "
            "(direction, dtype, shape, bytes, count, the function that "
            "made it); a seam with none is composed.  Today's crossings "
            "(the drained lanes down, the encode's inputs up) are "
            "committed; a new one fails, and a perf change that keeps the "
            "drained window on the card burns them down and re-baselines."),
        "bad": ("lanes = arena.consume(w).cpu()  # drained window to the host, "
                "then re-uploaded by the encode\n"),
        "good": ("feed consume's tensors straight to the encode's device "
                 "function, and re-baseline the burned-down crossings\n"),
    },
}
