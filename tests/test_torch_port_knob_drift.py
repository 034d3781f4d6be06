"""Doc/code knob drift for the port: the env-var tables in
docs/OBSERVABILITY.md and docs/SERVING.md versus the port's config-bus
registry (``horovod_tpu_torch/confbus.py``), the invariants of
``tests/test_knob_drift.py``:

* every ``HOROVOD_*`` documented in the tables is KNOWN to the registry;
* every runtime-mutable knob is documented;
* every Config-backed spec names a real field of the port's ``Config``;
* ``build_info()["config"]`` covers exactly the Config-backed knobs, the
  secret as a boolean;
* no knob is both mutable and shape-affecting;

and one more: the port's registry is the reference's -- the same env
names, fields, scopes, mutable / shape-affecting / secret flags and
measured-effect targets -- and ``KNOWN_ENV`` is the same set. Reasons may
differ only where the port's mechanism does (the call-site knob
``HOROVOD_HIERARCHICAL_ALLREDUCE`` and the request-trace label, whose
serving module is not ported), and the port's own ``Config`` fields (the
rendezvous contract) stay out of the registry.
"""

import dataclasses
import logging
import os
import re

import pytest

from horovod_tpu import confbus as RBUS
from horovod_tpu import config as RC
from horovod_tpu_torch import confbus
from horovod_tpu_torch import config as pconfig
from horovod_tpu_torch import core
from horovod_tpu_torch import metrics

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DOCS = ("docs/OBSERVABILITY.md", "docs/SERVING.md")

#: the registry entries whose reason text is the port's own
REASON_DIVERGES = {"HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_REQTRACE_LABEL"}
#: the port's own Config fields, outside the registry and its audit
PORT_ONLY_FIELDS = {"hierarchical_allreduce", "rank", "world_size",
                    "local_rank", "local_size", "master_addr", "master_port"}


def documented_envs():
    """``HOROVOD_*`` names from the FIRST cell of markdown table rows,
    mapped to the docs that carry them."""
    out = {}
    for doc in _DOCS:
        with open(os.path.join(_REPO, doc)) as f:
            for line in f:
                if not line.startswith("|"):
                    continue
                cells = line.split("|")
                if len(cells) < 3:
                    continue
                for env in re.findall(r"HOROVOD_\w+", cells[1]):
                    out.setdefault(env, set()).add(doc)
    return out


def test_documented_knobs_are_known():
    stale = sorted(set(documented_envs()) - confbus.KNOWN_ENV)
    assert not stale, f"documented in {_DOCS} but unknown: {stale}"


def test_mutable_knobs_are_documented():
    missing = sorted(set(confbus.mutable_knobs()) - set(documented_envs()))
    assert not missing, f"mutable but undocumented: {missing}"


def test_registry_fields_exist_on_config():
    fields = {f.name for f in dataclasses.fields(pconfig.Config)}
    ghost = sorted(f"{s.env} -> {s.field}"
                   for s in confbus.registry().values()
                   if s.field is not None and s.field not in fields)
    assert not ghost, f"registry names non-Config fields: {ghost}"


def test_build_info_covers_registry():
    info = core.build_info()
    resolved = confbus.resolved_values()
    assert set(info["config"]) == set(resolved)
    backed = {env for env, s in confbus.registry().items()
              if s.field is not None}
    assert set(resolved) == backed
    assert isinstance(info["config"]["HOROVOD_SERVE_AUTH_TOKEN"], bool)
    assert info["config_epoch"] == confbus.epoch()


def test_shape_affecting_disjoint_from_mutable():
    reg = confbus.registry()
    both = sorted(e for e in confbus.mutable_knobs()
                  if reg[e].shape_affecting)
    assert not both, f"mutable AND shape-affecting: {both}"


@pytest.mark.parametrize("env", sorted(RBUS.registry()))
def test_registry_entry_is_the_references(env):
    got, want = confbus.registry()[env], RBUS.registry()[env]
    for k in ("env", "field", "scope", "mutable", "shape_affecting",
              "secret", "target"):
        assert getattr(got, k) == getattr(want, k), k
    assert (got.parser is None) == (want.parser is None)
    if env not in REASON_DIVERGES:
        assert got.reason == want.reason


def test_registry_and_known_env_are_the_references():
    assert set(confbus.registry()) == set(RBUS.registry())
    assert confbus.KNOWN_ENV == RBUS.KNOWN_ENV
    assert confbus.mutable_knobs() == RBUS.mutable_knobs()
    assert set(pconfig._INERT_VARS) == set(RC._INERT_VARS)
    for name in ("LEDGER_ROTATE_BYTES", "EFFECT_THRESHOLD", "__all__"):
        assert getattr(confbus, name) == getattr(RBUS, name)


def test_config_fields_are_the_references_and_the_ports_own():
    ref = {f.name: f.default for f in dataclasses.fields(RC.Config)}
    port = {f.name: f.default for f in dataclasses.fields(pconfig.Config)}
    assert set(port) == set(ref) | PORT_ONLY_FIELDS
    assert {k: v for k, v in port.items() if k in ref} == ref
    assert not PORT_ONLY_FIELDS & {s.field for s in
                                   confbus.registry().values()}
    assert confbus._UNAUDITED_FIELDS == PORT_ONLY_FIELDS


def test_mutable_parsers_resolve_what_refresh_resolves(monkeypatch):
    """Each mutable knob's parser, with a value in the environment, gives
    what the reference's parser gives, and what ``refresh()`` puts in the
    field."""
    values = {"HOROVOD_SERVE_HEDGE_MS": "12.5",
              "HOROVOD_SERVE_RPC_TIMEOUT": "2",
              "HOROVOD_SERVE_MAX_RETRIES": "0",
              "HOROVOD_SERVE_BREAKER_FAILURES": "4",
              "HOROVOD_SERVE_BREAKER_RESET": "0.5",
              "HOROVOD_SERVE_PREFIX_CACHE": "yes",
              "HOROVOD_REQUEST_TRACE_DECODE_EVERY": "3",
              "HOROVOD_STALL_CHECK_TIME_SECONDS": "0.25",
              "HOROVOD_HEALTH_INTERVAL": "0.01",
              "HOROVOD_HEALTH_WINDOW": "9",
              "HOROVOD_HEALTH_FIRE_N": "5", "HOROVOD_HEALTH_CLEAR_M": "6",
              "HOROVOD_SLO_TTFT_P99_MS": "250",
              "HOROVOD_SLO_ERROR_RATE": "0.01",
              "HOROVOD_SLO_BURN_THRESHOLD": "3",
              "HOROVOD_SERVE_FLEET_PROBE": "0.2",
              "HOROVOD_METRICS_INTERVAL": "0.01",
              "HOROVOD_LOG_LEVEL": "INFO",
              "HOROVOD_CONFIG_REVERT_ON_REGRESSION": "1",
              "HOROVOD_CONFIG_EXPERIMENT_WINDOW": "7"}
    assert set(values) == set(confbus.mutable_knobs())
    level = logging.getLogger("horovod_tpu_torch").level
    for env, v in values.items():
        monkeypatch.setenv(env, v)
    try:
        cfg = pconfig.refresh()
        reg, rreg = confbus.registry(), RBUS.registry()
        for env in values:
            got = reg[env].parser()
            assert got == rreg[env].parser(), env
            assert got == getattr(cfg, reg[env].field), env
    finally:
        monkeypatch.undo()
        pconfig.refresh()
        confbus.reset()
        metrics.reset_metrics()
        logging.getLogger("horovod_tpu_torch").setLevel(level)
