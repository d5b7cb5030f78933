"""m3_tpu_torch stands alone: it imports neither JAX nor anything of
m3_tpu, so it runs where JAX is not installed."""

import pathlib
import re
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parent.parent / "m3_tpu_torch"
REF = PKG.parent / "m3_tpu"

# the reference's modules the port carries under another name: the codec
# scans, the three Pallas kernel files (each a wrapper module beside its
# hand-written kernels), the IR text classifier (the port has no XLA text:
# it classes aten dispatch records), the TPU bisector (card against CPU)
# and the jax lint family
RENAMED = {
    "encoding/m3tsz_jax.py": ["encoding/m3tsz_torch.py"],
    "parallel/pallas_encode.py": ["parallel/encode_place.py", "csrc/place_words.cu"],
    "parallel/pallas_decode.py": ["parallel/decode_gather.py", "csrc/extract_fields.cu"],
    "parallel/pallas_ingest.py": ["parallel/segment_ingest.py", "csrc/segment_ingest.cu",
                                  "csrc/segment_minmax.cu"],
    "x/hlotext.py": ["x/optext.py"],
    "tools/tpu_bisect.py": ["tools/card_bisect.py"],
    "x/lint/jaxlint.py": ["x/lint/torchlint.py"],
}


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    mods = list(_modules())
    assert "m3_tpu_torch.encoding.m3tsz_torch" in mods
    assert "m3_tpu_torch.aggregator.engine" in mods
    # the node: config, instruments, substrate, mediator, front door
    for m in ("core.config", "instrument", "instrument.procstats", "x",
              "x.admission", "x.breaker", "x.diskbudget", "x.retry",
              "storage.mediator", "storage.scrub", "server.snappy",
              "server.prom_remote", "server.influx", "server.http_api",
              "server.assembly", "server.node_main",
              # the aggregator tier: wire, ingest, client, placements, bus
              "msg.protocol", "msg.bus", "msg.transport", "server.ingest_tcp",
              "client.aggregator_client", "cluster.placement",
              "cluster.placement_mirrored", "collector.reporter", "tools.hops",
              # the mesh: topology, replicas, the sharded step, codec and query
              "parallel", "parallel.mesh", "parallel.replication", "parallel.sharded_agg",
              "parallel.sharded_encode", "parallel.sharded_decode",
              "parallel.sharded_query",
              # the replicated storage cluster: RPC, session, KV service,
              # topology, namespaces, runtime options, repair, migration, admin
              "server.rpc", "client", "client.session", "cluster.kv_remote",
              "cluster.topology", "cluster.namespace_registry",
              "core.runtime_options", "storage.repair", "storage.migration",
              "server.admin_api",
              # the device boundary and the control plane
              "x.devguard", "x.membudget", "instrument.exposition",
              "query.slo", "instrument.selfmon", "instrument.debug",
              "x.controller", "x.chaos", "ctl", "ctl.r2",
              # query federation and the Graphite front door
              "metrics.carbon", "query.graphite", "query.fanout", "query.remote",
              # the proto value codec and the runtime instruments
              "encoding.proto_codec", "encoding.proto_schema", "x.lockcheck",
              "x.devseams", "x.hopwatch", "x.tracewatch",
              # the measuring tools
              "x.optext", "x.costwatch", "tools.costs", "tools.decode_profile",
              "tools.card_bisect", "native.aggproxy", "comparator",
              "comparator.naive_promql", "comparator.harness",
              # the static and IR gates
              "x.lint", "x.lint.core", "x.lint.locks", "x.lint.wirecheck",
              "x.lint.faultcov", "x.lint.resources", "x.lint.corruption",
              "x.lint.placement", "x.lint.deadline_aware", "x.lint.metrics_rule",
              "x.lint.actuator_rule", "x.lint.capacity_rule", "x.lint.purity",
              "x.lint.torchlint", "x.lint.devguard_rule", "x.lint.registry_rule",
              "x.irlint",
              # the ops CLI and the distributed tests
              "tools.cli", "dtest", "dtest.harness", "dtest.agent", "dtest.soak"):
        assert f"m3_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['m3_tpu'] = None\n"
            f"sys.path.insert(0, {str(PKG.parent)!r})\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or k == 'm3_tpu'"
            " or k.startswith('m3_tpu.') for k, v in sys.modules.items()"
            " if v is not None)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_sources_name_no_jax_or_reference_package():
    bad = re.compile(r"^\s*(import|from)\s+(jax\b|m3_tpu\b(?!_torch))", re.M)
    for p in list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]:
        assert not bad.search(p.read_text()), p


def test_every_reference_module_has_its_counterpart():
    """Every module of ``m3_tpu/`` has a file at the same path in
    ``m3_tpu_torch/``, or its listed rename: the port does all that the
    JAX package does."""
    missing = []
    for p in sorted(REF.rglob("*.py")):
        rel = p.relative_to(REF).as_posix()
        want = RENAMED.get(rel, [rel])
        missing += [f"{rel} -> {w}" for w in want if not (PKG / w).is_file()]
    assert not missing, missing
    # a rename whose reference module is gone would hide a stale entry
    assert all((REF / rel).is_file() for rel in RENAMED)
    assert not any((PKG / rel).exists() for rel in RENAMED)
