"""repro_torch.analysis against repro.analysis: the port's tag and
parameter-path universes equal the reference's for every arch (the MoE
experts' ``moe_expert`` plans apart, which the port records and the
reference misses), each PT fixture gives the same single finding in both
packages (fingerprints included), the CLI agrees with the reference's on
exit codes, JSON and SARIF, the baseline round-trips, and the port's own
code comes out clean against the live universes."""
import dataclasses
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

import repro.analysis as ref_analysis
from repro.analysis import astutil as ref_astutil
from repro.analysis import cli as ref_cli
from repro.analysis import policy_check as ref_pc
from repro.analysis.findings import RULES as REF_RULES
from repro_torch import configs
from repro_torch.analysis import (RULES, Baseline, analyze_paths,
                                  changed_files, main, to_sarif)
from repro_torch.analysis import policy_check as pc
from repro_torch.analysis.findings import register_rule
from repro_torch.core import controller, policy
import test_torch_lints

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "analysis")
ARCHS = list(configs.ARCH_NAMES)
MOE_ARCHS = {"granite-moe-1b-a400m", "dbrx-132b"}

# The synthetic universes of tests/test_analysis.py (a tiny MoE config).
UNIVERSE = {
    "toy-moe": {
        "b0/attn_q": "token",
        "b0/attn_o": "token",
        "b0/mlp_up": "token",
        "b0/moe_router": "rows",
    },
}
PARAM_UNIVERSE = {
    "toy-moe": [
        "embed",
        "b0/attn_q/w",
        "b0/mlp_up/w",
        "b0/norm/gamma",
    ],
}

# fixture -> the one rule it fires
PT_FIXTURES = [
    ("bad_policy.py", "PT001"),
    ("bad_policy_uncovered.py", "PT002"),
    ("bad_policy_cached_rows.py", "PT003"),
    ("bad_policy_shadowed.py", "PT004"),
    ("bad_policy_schedule.py", "PT008"),
    ("bad_rank_schedule.py", "PT008"),
    ("bad_rank_controller.py", "PT008"),
    ("bad_optim_rule_dead.py", "PT001"),
    ("bad_optim_rule_shadowed.py", "PT004"),
    ("bad_syntax.py", "AN001"),
]
# rules judging the baseline itself: test_baseline_audit_as_the_reference
BASELINE_META_RULES = {"AN002", "AN003"}


def fixture(name):
    return os.path.join(FIX, name)


def records(findings):
    return [f.to_json() for f in findings]


@pytest.fixture(scope="module")
def universes():
    """The live universes of both packages, built once for the module
    (each package also caches them per process)."""
    return {"port_tags": pc.tag_universe(),
            "port_paths": pc.param_path_universe(),
            "ref_tags": ref_pc.tag_universe(),
            "ref_paths": ref_pc.param_path_universe()}


@pytest.fixture
def elsewhere(tmp_path, monkeypatch):
    """Run a CLI from a directory holding no baseline of either
    package."""
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.fixture
def synthetic(elsewhere, monkeypatch):
    """Both CLIs against the synthetic universes (the live ones differ by
    the experts' tag, and PT001's message counts the distinct tags)."""
    for mod in (pc, ref_pc):
        monkeypatch.setattr(mod, "tag_universe",
                            lambda reduced=True: UNIVERSE)
        monkeypatch.setattr(mod, "param_path_universe",
                            lambda reduced=True: PARAM_UNIVERSE)
    return elsewhere


# -- universes ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tag_universe_equals_the_reference_but_for_the_experts(
        universes, arch):
    port, ref = universes["port_tags"][arch], universes["ref_tags"][arch]
    # exact equality of {tag: dim} once the experts' plans are set aside
    assert {t: d for t, d in port.items()
            if not t.endswith("moe_expert")} == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_param_path_universe_equals_the_reference(universes, arch):
    # exact equality of the sorted distinct paths
    assert universes["port_paths"][arch] == universes["ref_paths"][arch]


def test_port_records_the_experts_the_reference_misses(universes):
    """The reference's ``_expert_ffn`` resolves ``<prefix>moe_expert``
    through the policy but never records it; the port's recorder notes it
    (``expert_calls``) and the universe keeps it as a rows-dim tag."""
    for arch in ARCHS:
        port, ref = universes["port_tags"][arch], universes["ref_tags"][arch]
        extra = {t: d for t, d in port.items() if t not in ref}
        assert extra == ({"b0/moe_expert": "rows"} if arch in MOE_ARCHS
                         else {}), arch
        assert not any(t.endswith("moe_expert") for t in ref), arch


EXPERT_RULE = '''"""A rule on the MoE experts' plans."""
from repro_torch.core import PolicyRules, WTACRSConfig

CFG = WTACRSConfig(kind="wta_crs", budget=0.3{extra})

RULES = PolicyRules.of(
    ("*moe_expert", CFG),
)
'''


@pytest.mark.parametrize("cached,port_rules", [
    (False, []), (True, ["PT003"])])
def test_expert_rule_is_dead_to_the_reference_only(universes, tmp_path,
                                                   cached, port_rules):
    """``("*moe_expert", cfg)`` is live (``models/mlp.py`` resolves it for
    every expert FFN): the reference calls it dead (PT001), the port is
    silent, and under CACHED_GRAD the port fires PT003, since an expert's
    plans run over capacity slots with no per-sample cache column."""
    path = tmp_path / "expert_rule.py"
    path.write_text(EXPERT_RULE.format(
        extra=', norm_source="cached_grad"' if cached else ""))
    port = analyze_paths([str(path)])
    ref = ref_analysis.analyze_paths([str(path)])
    assert [f.rule for f in port] == port_rules
    assert [f.rule for f in ref] == ["PT001"]
    assert "'*moe_expert' matches no tag" in ref[0].message
    if cached:
        assert "b0/moe_expert" in port[0].message


def test_port_caches_are_keyed_by_reduced(monkeypatch):
    """A call at the other ``reduced`` builds its own universe; the same
    ``reduced`` again returns the cached one.  The configs are stood in
    for (one arch, reduced=False served by another reduced arch), so no
    published-size model is traced here."""
    real = configs.get_config
    monkeypatch.setattr(pc, "_universe_cache", {})
    monkeypatch.setattr(pc, "_param_universe_cache", {})
    monkeypatch.setattr(configs, "ARCH_NAMES", ["qwen2.5-3b"])
    monkeypatch.setattr(configs, "get_config", lambda name, reduced: real(
        name if reduced else "granite-moe-1b-a400m", reduced=True))
    for build in (pc.tag_universe, pc.param_path_universe):
        small, full = build(reduced=True), build(reduced=False)
        assert small != full
        assert build(reduced=True) is small
        assert build(reduced=False) is full
    assert "b0/moe_router" in pc.tag_universe(reduced=False)["qwen2.5-3b"]
    assert "b0/moe_router" not in pc.tag_universe()["qwen2.5-3b"]


def test_reference_caches_ignore_reduced(monkeypatch):
    """The reference's fault: whatever was built first is returned for
    either ``reduced`` (``policy_check.py:78-80, 111-113``)."""
    tags, paths = {"first": {"t": "token"}}, {"first": ["p"]}
    monkeypatch.setattr(ref_pc, "_universe_cache", tags)
    monkeypatch.setattr(ref_pc, "_param_universe_cache", paths)
    assert ref_pc.tag_universe(reduced=False) is tags
    assert ref_pc.param_path_universe(reduced=False) is paths


# -- the PT008 tables mirror the port's dataclasses and the reference ---------

def _field_defaults(cls, names):
    fields = {f.name: f.default for f in dataclasses.fields(cls)}
    return {n: float(fields[n]) for n in names}


@pytest.mark.parametrize("table,cls", [
    ("_SCHED_DEFAULTS", policy.BudgetSchedule),
    ("_RANK_SCHED_DEFAULTS", policy.RankSchedule),
    ("_CTRL_DEFAULTS", controller.ESSProportional),
    ("_CTRL_DEFAULTS", controller.ConditionRate),
    ("_FIXED_DEFAULTS", controller.FixedSchedule),
    ("_RANK_CTRL_DEFAULTS", controller.RankController),
])
def test_pt008_defaults_are_the_ports_and_the_references(table, cls):
    mine = getattr(pc, table)
    # exact: the port's dataclass defaults, and the reference's table
    assert mine == _field_defaults(cls, mine)
    assert mine == getattr(ref_pc, table)


@pytest.mark.parametrize("table,cls,args", [
    ("_SCHED_POS", policy.BudgetSchedule,
     {"linear": (0.9, 0.2, 1, 5, 3), "warmup_exact": (2, 0.4),
      "constant": (0.5,)}),
    ("_RANK_SCHED_POS", policy.RankSchedule,
     {"linear": (30, 4, 1, 5, 3), "constant": (8,)}),
])
def test_pt008_positional_fields_are_the_classmethods(table, cls, args):
    """Each classmethod's positional arguments land in the fields the
    table names, in its order."""
    mine = getattr(pc, table)
    assert set(mine) == set(args)
    for kind, names in mine.items():
        sched = getattr(cls, kind)(*args[kind])
        assert tuple(getattr(sched, n) for n in names) == args[kind], kind
    assert mine == getattr(ref_pc, table)
    assert pc._CTRL_LEAVES == ref_pc._CTRL_LEAVES
    assert pc._HORIZON_NAMES == ref_pc._HORIZON_NAMES


# -- fixtures: one rule once, the same record in both packages ---------------

@pytest.mark.parametrize("name,rule", PT_FIXTURES)
def test_fixture_fires_its_rule_once_as_the_reference(name, rule):
    kw = dict(tag_universe=UNIVERSE, param_universe=PARAM_UNIVERSE)
    port = analyze_paths([fixture(name)], **kw)
    ref = ref_analysis.analyze_paths([fixture(name)], **kw)
    assert [f.rule for f in port] == [rule]
    # rule, severity, path, line, column, symbol, message, fingerprint
    assert records(port) == records(ref)


STRING_CACHED = '''"""CACHED_GRAD spelled as the port spells it."""
from repro_torch.core import PolicyRules, WTACRSConfig

CFG = WTACRSConfig(kind="wta_crs", budget=0.3, norm_source="cached_grad")

RULES = PolicyRules.of(
    ("*moe_router", CFG),
)
'''


def test_cached_grad_string_fires_pt003_in_the_port_only(tmp_path):
    """The config dataclasses coerce ``norm_source="cached_grad"``; the
    reference's checker reads only the enum member, so it misses the
    rows-dim rule that the port's fires on."""
    path = tmp_path / "string_cached.py"
    path.write_text(STRING_CACHED)
    kw = dict(tag_universe=UNIVERSE, param_universe=PARAM_UNIVERSE)
    port = analyze_paths([str(path)], **kw)
    assert [f.rule for f in port] == ["PT003"]
    assert ref_analysis.analyze_paths([str(path)], **kw) == []
    # the enum spelling gives both packages the same record
    path.write_text(STRING_CACHED.replace(
        'norm_source="cached_grad"', "norm_source=NormSource.CACHED_GRAD"))
    assert records(port) == records(
        ref_analysis.analyze_paths([str(path)], **kw))


def test_clean_fixture_is_silent():
    assert analyze_paths([fixture("clean.py")], tag_universe=UNIVERSE,
                         param_universe=PARAM_UNIVERSE) == []


def test_registry_ids_unique_covered_and_the_references():
    with pytest.raises(ValueError):
        register_rule("PT001", "error", "imposter")
    assert "imposter" not in RULES["PT001"][1]
    covered = ({rule for _, rule in PT_FIXTURES} | BASELINE_META_RULES
               | {rule for _, rule, _, _ in test_torch_lints.FIXTURES})
    assert set(RULES) == covered
    # the same ids with the same severities, every family; the same
    # descriptions where the words carry over (the JL and PK rules read
    # eager torch and CUDA C++, not jit and Pallas)
    assert set(RULES) == set(REF_RULES)
    assert {r: REF_RULES[r][0] for r in RULES} == \
        {r: sev for r, (sev, _) in RULES.items()}
    assert {r: REF_RULES[r] for r in RULES if r[:2] in ("AN", "PT")} == \
        {r: v for r, v in RULES.items() if r[:2] in ("AN", "PT")}


# -- baseline -----------------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    findings = analyze_paths([fixture("bad_policy.py")],
                             tag_universe=UNIVERSE)
    bl = Baseline.from_findings(findings, justification="known; tracked")
    p = tmp_path / "baseline.json"
    bl.save(str(p))
    loaded = Baseline.load(str(p))
    assert all(loaded.is_suppressed(f) for f in findings)
    assert loaded.audit() == []
    ref = ref_analysis.Baseline.load(str(p))
    assert ref.entries == loaded.entries


def test_baseline_audit_as_the_reference(tmp_path):
    """An unjustified entry (AN002) and a stale one (AN003), each the
    reference's record."""
    findings = analyze_paths([fixture("bad_policy.py")],
                             tag_universe=UNIVERSE)
    bl = Baseline.from_findings(findings)
    bl.entries.append({"fingerprint": "deadbeefdeadbeef", "rule": "PT001",
                       "location": "gone.py:f", "justification": "old"})
    p = str(tmp_path / "baseline.json")
    bl.save(p)
    audits = []
    for pkg in (ref_analysis, sys.modules["repro_torch.analysis"]):
        loaded = pkg.Baseline.load(p)
        for f in findings:
            loaded.is_suppressed(f)
        audits.append(records(loaded.audit()))
    assert sorted(f["rule"] for f in audits[1]) == ["AN002", "AN003"]
    assert audits[0] == audits[1]


def test_baseline_version_mismatch(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"version": 99, "suppressions": []}))
    with pytest.raises(ValueError):
        Baseline.load(str(p))


# -- CLI, against the reference's on the same files ---------------------------

def _both(argv, capsys):
    """(exit code, stdout) of the port's CLI and of the reference's."""
    out = []
    for run in (main, ref_cli.main):
        code = run(list(argv))
        out.append((code, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("argv,code", [
    ([fixture("bad_policy.py")], 1),
    ([fixture("clean.py")], 0),
    ([fixture("bad_policy_uncovered.py")], 0),            # a note
    ([fixture("bad_policy_uncovered.py"), "--fail-on", "note"], 1),
    ([fixture("bad_policy_shadowed.py")], 1),             # a warning
    ([fixture("bad_policy_shadowed.py"), "--fail-on", "error"], 0),
    ([fixture("bad_policy.py"), "--select", "PT008"], 0),
    ([fixture("bad_policy.py"), "--select", "PT001,PT008"], 1),
    ([fixture("bad_syntax.py"), "--no-policy"], 1),
    ([os.path.join(FIX, "no_such_file.py")], 2),
])
def test_cli_exit_codes_as_the_reference(synthetic, capsys,
                                         argv, code):
    (port, _), (ref, _) = _both(argv, capsys)
    assert port == ref == code


def test_cli_list_rules(capsys):
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert all(rule in out for rule in RULES)


PT_PATHS = [fixture(n) for n, _ in PT_FIXTURES] + [fixture("clean.py")]


@pytest.mark.parametrize("fmt", [["--format", "json"], ["--json"]])
def test_cli_json_as_the_reference(synthetic, capsys, fmt):
    (pc_, port), (rc_, ref) = _both(PT_PATHS + fmt, capsys)
    assert pc_ == rc_ == 1
    doc = json.loads(port)
    assert doc == json.loads(ref)
    assert doc["failing"] == sum(
        f["severity"] in ("error", "warning") for f in doc["findings"])
    assert {f["rule"] for f in doc["findings"]} >= {"PT001", "PT008",
                                                    "AN001"}


def test_cli_sarif_as_the_reference(synthetic, capsys):
    (_, port), (_, ref) = _both(PT_PATHS + ["--format", "sarif"], capsys)
    port, ref = json.loads(port), json.loads(ref)
    assert port == to_sarif(analyze_paths(
        PT_PATHS, tag_universe=UNIVERSE, param_universe=PARAM_UNIVERSE))
    assert port["version"] == "2.1.0"
    tool = port["runs"][0]["tool"]["driver"]
    assert tool["name"] == "repro_torch.analysis"
    # the same document but for the tool's name
    tool["name"] = "repro.analysis"
    assert port == ref


def test_cli_text_as_the_reference(synthetic, capsys):
    (_, port), (_, ref) = _both(PT_PATHS, capsys)
    port, ref = port.splitlines(), ref.splitlines()
    assert port[:-1] == ref[:-1]
    assert port[-1].startswith("repro_torch.analysis: ")
    assert port[-1].split(": ", 1)[1] == ref[-1].split(": ", 1)[1]


def test_cli_write_baseline_then_suppress(elsewhere, capsys):
    bl = str(elsewhere / "bl.json")
    target = fixture("bad_rank_controller.py")
    assert main([target, "--write-baseline", bl]) == 0
    # unjustified entries themselves gate (AN002)
    assert main([target, "--baseline", bl]) == 1
    assert "AN002" in capsys.readouterr().out
    with open(bl, encoding="utf-8") as f:
        data = json.load(f)
    for e in data["suppressions"]:
        e["justification"] = "fixture: intentionally bad"
    stale = dict(data["suppressions"][0], fingerprint="deadbeefdeadbeef")
    data["suppressions"].append(stale)
    with open(bl, "w", encoding="utf-8") as f:
        json.dump(data, f)
    capsys.readouterr()
    # the stale entry is a note: reported, not gating
    assert main([target, "--baseline", bl]) == 0
    out = capsys.readouterr().out
    assert "1 baselined" in out and "AN003" in out
    with open(bl, "w", encoding="utf-8") as f:
        json.dump({"version": 2, "suppressions": []}, f)
    assert main([target, "--baseline", bl]) == 2


def test_cli_reads_its_own_default_baseline(elsewhere, capsys):
    """``torch-analysis-baseline.json`` in the working directory is read;
    the reference's ``analysis-baseline.json`` is not."""
    target = fixture("bad_rank_controller.py")
    findings = analyze_paths([target])
    Baseline.from_findings(findings, justification="x").save(
        str(elsewhere / "analysis-baseline.json"))
    assert main([target]) == 1
    os.rename(elsewhere / "analysis-baseline.json",
              elsewhere / "torch-analysis-baseline.json")
    capsys.readouterr()
    assert main([target]) == 0
    assert "1 baselined" in capsys.readouterr().out


def test_changed_only(tmp_path, monkeypatch, capsys):
    """--changed-only scopes to git-diff files (plus untracked)."""
    repo = tmp_path / "repo"
    repo.mkdir()
    monkeypatch.chdir(repo)
    for cmd in (["git", "init", "-q"],
                ["git", "config", "user.email", "t@example.com"],
                ["git", "config", "user.name", "t"]):
        subprocess.run(cmd, check=True, capture_output=True)
    (repo / "clean.py").write_text("X = 1\n")
    subprocess.run(["git", "add", "."], check=True)
    subprocess.run(["git", "commit", "-qm", "seed"], check=True)

    assert main([".", "--changed-only", "HEAD"]) == 0
    assert "no changed python files" in capsys.readouterr().out

    (repo / "clean.py").write_text(
        "from repro_torch.core import RankController\n\nSTEPS = 4\n"
        "CTRL = RankController(levels=6, warmup=3)\n")
    assert main([".", "--changed-only", "HEAD"]) == 1
    assert "PT008" in capsys.readouterr().out

    (repo / "fresh.py").write_text("Y = 2\n")
    got = changed_files("HEAD", ["."])
    assert [os.path.basename(p) for p in got] == ["clean.py", "fresh.py"]
    assert changed_files("HEAD", [str(repo / "elsewhere")]) == []
    assert main([".", "--changed-only", "no-such-ref"]) == 2


def _python(code_or_args, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *code_or_args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=120)


def test_module_entrypoint_subprocess(elsewhere):
    """``python -m repro_torch.analysis`` is the documented interface."""
    done = _python(["-m", "repro_torch.analysis", "--no-policy",
                    fixture("bad_syntax.py")], elsewhere)
    assert done.returncode == 1, done.stderr
    assert "AN001" in done.stdout


def test_no_policy_imports_no_torch(elsewhere):
    code = ("import sys\n"
            "from repro_torch.analysis import main\n"
            f"rc = main([{FIX!r}, '--no-policy'])\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('torch', 'jax', 'repro')]\n"
            "assert rc == 1 and not bad, (rc, bad)\n")
    done = _python(["-c", code], elsewhere)
    assert done.returncode == 0, done.stderr


# -- the port's own code ------------------------------------------------------

PORT_PATHS = ["src/repro_torch", "chip_smoke.py", "tools"] + sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))


def test_port_tree_is_clean_with_its_baseline(universes, monkeypatch):
    """No error or warning against the live universes once the port's
    baseline is applied (the JL and PK families, ``kernels/csrc``
    included, gate through it alone), and no entry of it unjustified or
    stale."""
    monkeypatch.chdir(ROOT)
    findings = analyze_paths(PORT_PATHS)
    baseline = Baseline.load("torch-analysis-baseline.json")
    live = [f for f in findings if not baseline.is_suppressed(f)]
    live += baseline.audit()
    gating = [f.render() for f in live
              if f.severity in ("error", "warning")
              or f.rule in BASELINE_META_RULES]
    assert not gating, gating
    # the reference's policy checker over the same files finds the same
    # PT and AN records
    modules, _ = ref_astutil.load_modules(PORT_PATHS)
    assert [r for r in records(findings) if r["rule"][:2] in ("PT", "AN")] \
        == records(ref_analysis.sort_findings(ref_pc.check(modules)))
