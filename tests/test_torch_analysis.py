"""The port's analysis passes (`repro_torch.analysis`) on the CPU, case for
case with tests/test_analysis.py where the reference's test has a
counterpart: the eager trace check against seeded leaks (and clean on the
port's SGPR and GP-LVM losses with their gradients through every
backend), its scaling classes against the reference's jaxpr check on the
same functions, the kernel audit against a bloated launch plan (and clean
on the seven kernels over a stand-in H100), the AST rules ANL001-ANL004
against seeded sources (and clean on the tree), the `launch.memory`
wrappers and the CLI."""
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_check
from repro_torch import analysis
from repro_torch.analysis import kernel_audit, lint
from repro_torch.kernels import suffstats as tss
from repro_torch.launch.memory import intermediate_report, peak_intermediate_bytes

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "torch_analysis"


def _load_fixture(name):
    spec = importlib.util.spec_from_file_location(f"torch_{name}", FIXTURES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xz(N=2048, M=64, Q=3, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(N, Q)), dtype=torch.float32),
            torch.as_tensor(rng.normal(size=(M, Q)), dtype=torch.float32))


# ---------------------------------------------------------------------------
# trace check
# ---------------------------------------------------------------------------

def test_leaky_chunks_fixture_flags_exactly_the_concatenation():
    mod = _load_fixture("leaky_chunks")
    N, M, Q = 2048, 64, 3
    X, Z = _xz(N, M, Q)
    sizes = {"N": N, "M": M, "Q": Q}
    with pytest.raises(analysis.ScalingViolation) as exc:
        analysis.assert_no_scaling(mod.leaky_chunked_loss, X, Z,
                                   axis="N", worse_than="N*M", sizes=sizes)
    # the finding is the (N, M) concatenation, named with its op and its
    # source line in the fixture — and it is the only O(N*M)-class entry
    viol = exc.value.violations
    assert [(v.op, v.label, v.shape) for v in viol] == [("cat", "O(N*M)", (N, M))]
    assert "leaky_chunks.py:25" in viol[0].source
    # the same loss without the leak passes the same bound
    analysis.assert_no_scaling(mod.clean_chunked_loss, X, Z,
                               axis="N", worse_than="N*M", sizes=sizes)


def test_saved_activations_of_a_chunk_loop_add_up():
    """With its backward pass the clean loop saves every chunk's exp for
    autograd: one call site, but N / chunk live buffers — O(N*M) in all.
    Checkpointing each chunk saves only its inputs and passes."""
    mod = _load_fixture("leaky_chunks")
    N, M, Q = 2048, 64, 3
    X, Z = _xz(N, M, Q)
    sizes = {"N": N, "M": M, "Q": Q}
    with pytest.raises(analysis.ScalingViolation) as exc:
        analysis.assert_no_scaling(mod.clean_chunked_loss, X, Z, axis="N",
                                   sizes=sizes, backward=True)
    assert any(v.op == "saved_for_backward" and v.growth_exp == 1 and v.coeff >= M
               and "leaky_chunks.py" in v.source
               for v in exc.value.violations), exc.value.violations
    analysis.assert_no_scaling(mod.checkpointed_chunked_loss, X, Z, axis="N",
                               sizes=sizes, backward=True)


def test_scaling_report_classes_and_worst():
    X, Z = _xz()
    sizes = {"N": 2048, "M": 64, "Q": 3}

    def dense(X, Z):
        return torch.exp(-((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)).sum()

    rep = analysis.scaling_report(dense, X, Z, axis="N", sizes=sizes)
    assert rep.worst_class == "O(N*M*Q)"
    assert rep.worst.growth_exp == 1
    assert "O(N*M*Q)" in rep.format(top=3)
    assert analysis.scaling_class(dense, X, Z, axis="N", sizes=sizes) == "O(N*M*Q)"


def _dense_torch(X, Z):
    return torch.exp(-((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)).sum()


def _dense_jax(X, Z):
    return jnp.exp(-((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)).sum()


@pytest.mark.parametrize("name,fn_torch,fn_jax,want", [
    ("dense", _dense_torch, _dense_jax, "O(N*M*Q)"),
    ("cross", lambda X, Z: (X @ Z.T).sum(), lambda X, Z: (X @ Z.T).sum(), "O(N*M)"),
    ("scaled", lambda X, Z: ((2.0 * X).sum(0) @ Z.T).sum(),
     lambda X, Z: ((2.0 * X).sum(0) @ Z.T).sum(), "O(N*Q)"),
])
def test_worst_class_agrees_with_the_reference_jaxpr_check(name, fn_torch, fn_jax, want):
    """The same function, the same sizes: the eager trace's worst class is
    the one the reference reads off the jaxpr."""
    X, Z = _xz()
    sizes = {"N": 2048, "M": 64, "Q": 3}
    ref = jaxpr_check.scaling_class(
        fn_jax, jax.ShapeDtypeStruct(tuple(X.shape), jnp.float32),
        jax.ShapeDtypeStruct(tuple(Z.shape), jnp.float32), axis="N", sizes=sizes)
    assert analysis.scaling_class(fn_torch, X, Z, axis="N", sizes=sizes) == ref == want


def test_margin_semantics_allow_the_output_cotangent_itself():
    """An exactly-(N, M) buffer violates the default margin=4 bound but
    passes margin=0.5 ("nothing beyond 2x the (N, M) output")."""
    X, Z = _xz()
    sizes = {"N": 2048, "M": 64, "Q": 3}

    def makes_nm(X, Z):
        return (X @ Z.T).sum()

    with pytest.raises(analysis.ScalingViolation):
        analysis.assert_no_scaling(makes_nm, X, Z, axis="N",
                                   worse_than="N*M", sizes=sizes)
    analysis.assert_no_scaling(makes_nm, X, Z, axis="N", worse_than="N*M",
                               margin=0.5, sizes=sizes)


def test_bound_parsing_rejects_unknown_names_and_axisless_bounds():
    X, Z = _xz()
    sizes = {"N": 2048, "M": 64}
    with pytest.raises(ValueError, match="neither the axis"):
        analysis.assert_no_scaling(lambda x, z: x.sum(), X, Z,
                                   axis="N", worse_than="N*K", sizes=sizes)
    with pytest.raises(ValueError, match="must involve the grown axis"):
        analysis.assert_no_scaling(lambda x, z: x.sum(), X, Z,
                                   axis="N", worse_than="M", sizes=sizes)
    with pytest.raises(ValueError, match="sizes="):
        analysis.assert_no_scaling(lambda x, z: x.sum(), X, Z, axis="N")


def test_structure_change_across_dispatch_boundary_is_an_analysis_error():
    """A size-dependent python branch between the two sizes cannot be
    classified — the analyzer must say so instead of mispairing sites."""
    def dispatching(x):
        if x.shape[0] > 1024:
            return (2.0 * x * x).sum()
        return x.sum()

    x = torch.ones(1024, 2)
    with pytest.raises(analysis.AnalysisError, match="structure changed"):
        analysis.scaling_report(dispatching, x, axis="N", sizes={"N": 1024})


def test_unrolled_chunk_loops_pair_by_call_site():
    """Twice the chunks run at twice N: the per-chunk buffer keeps one site
    and reads O(1); what accumulates across chunks reads O(1) too."""
    def chunked(x):
        acc = x.new_zeros(())
        for i in range(0, x.shape[0], 128):
            acc = acc + torch.exp(x[i:i + 128, None] * x[None, :128]).sum()
        return acc

    rep = analysis.scaling_report(chunked, torch.rand(1024), axis="N",
                                  sizes={"N": 1024})
    assert rep.entries and all(e.growth_exp == 0 for e in rep.entries)


def test_trace_intermediates_names_op_and_source():
    def f(x):
        return torch.exp(x).sum()

    rows = analysis.trace_intermediates(f, torch.ones(8, 3))
    ops = [r[3] for r in rows]
    assert "exp" in ops and "sum" in ops
    exp_row = rows[ops.index("exp")]
    assert exp_row[0] == (8, 3) and "test_torch_analysis.py" in exp_row[4]


def test_backward_ops_name_the_forward_line_that_made_their_node():
    """A backward op of one of autograd's own nodes has no Python frame;
    the trace attributes it to the forward line (anomaly traceback)."""
    def f(x):
        y = torch.sin(x)
        return (y * y).sum()

    rows = analysis.trace_intermediates(f, torch.ones(16, 2), backward=True)
    back = [r for r in rows if "backward:" in r[4]]
    assert back and all("test_torch_analysis.py" in r[4] for r in back)
    assert any("SinBackward0" in r[4] for r in back)
    assert any(r[3] == "saved_for_backward" for r in rows)


def test_launch_memory_wrappers_still_serve_bytes():
    def f(x):
        return (x[:, None] * x[None, :]).sum()

    x = torch.ones(64)
    rows = intermediate_report(f, x, top=2)
    assert rows[0][0] == (64, 64)
    assert peak_intermediate_bytes(f, x) == 64 * 64 * x.element_size()


def _loss_case(model, backend):
    from repro_torch.gp import BayesianGPLVM, SparseGPRegression

    N, M, Q, D = 2048, 16, 1, 3
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(-3.0, 3.0, (N, Q)))
    Y = torch.as_tensor(rng.normal(size=(N, D)))
    chunk = None if backend == "fused" else 512
    sizes = {"N": N, "M": M, "Q": Q, "D": D}
    if model == "sgpr":
        m = SparseGPRegression(M=M, backend=backend, chunk=chunk, device="cpu")
        return m._loss, (m.init_params(X, Y), X, Y), sizes
    m = BayesianGPLVM(M=M, backend=backend, chunk=chunk, device="cpu")
    return m._loss, (m.init_params(Y), Y), sizes


@pytest.mark.parametrize("backend", ["jnp", "fused", "pallas"])
@pytest.mark.parametrize("model", ["sgpr", "gplvm"])
def test_port_losses_and_gradients_hold_the_memory_guarantee(model, backend):
    """The guarantee, stated once: no intermediate of the loss or of its
    gradients grows like N*M — "fused" in one shot, "jnp" and "pallas"
    over checkpointed chunks."""
    loss, args, sizes = _loss_case(model, backend)
    rep = analysis.assert_no_scaling(loss, *args, axis="N", worse_than="N*M",
                                     sizes=sizes, backward=True)
    assert rep.worst.growth_exp <= 1


def test_unchunked_plain_path_is_flagged_with_its_op_and_line():
    """The plain ("jnp") statistics in one shot make psi1 (N, M): the check
    names it."""
    from repro_torch.gp import BayesianGPLVM

    Y = torch.as_tensor(np.random.default_rng(0).normal(size=(2048, 3)))
    m = BayesianGPLVM(M=16, backend="jnp", device="cpu")
    with pytest.raises(analysis.ScalingViolation) as exc:
        analysis.assert_no_scaling(m._loss, m.init_params(Y), Y, axis="N",
                                   sizes={"N": 2048, "M": 16, "Q": 1, "D": 3})
    assert any(v.shape == (2048, 16) and "ref.py" in v.source
               for v in exc.value.violations), exc.value.violations


# ---------------------------------------------------------------------------
# kernel audit
# ---------------------------------------------------------------------------

def test_clean_tree_kernels_audit_clean():
    audits = kernel_audit.audit_kernels()
    assert [a.name for a in audits] == [n for n in kernel_audit.KERNELS for _ in range(2)]
    assert [a.dtype for a in audits] == ["float32", "float64"] * 7
    for a in audits:
        assert a.fits and not a.findings, (a.name, a.findings)
        assert 0 < a.smem_bytes <= kernel_audit.SMEM_BUDGET_BYTES
        assert a.compute == {"bfloat16": "float32", "float16": "float32",
                             "float32": "float32", "float64": "float64"}
    # the reverse kernels' extra passes are planned: B2 pair and point (its
    # point pass sums dZ's psi1 part)
    by = {(a.name, a.dtype): a for a in audits}
    assert [p.name for p in by["suffstats_bwd_pallas", "float32"].passes] == [
        "pair", "point"]


def test_audit_plans_every_split_of_the_dry_run_shape():
    audits = kernel_audit.audit_kernels(kernel_audit.Problem(16_777_216, 128, 1, 3))
    assert all(a.fits and not a.findings for a in audits)
    b2 = next(a for a in audits if a.name == "suffstats_bwd_pallas")
    card = kernel_audit.StandInCard()
    geo = card.psi2_geometry("suffstats_bwd", torch.float32, 1)
    # one wave of point-pass blocks walks each chunk's 256-point tiles
    blocks = card.point_resident(torch.float32, 1) * card.sms
    assert b2.passes[1].grid == (blocks,)
    assert blocks == tss.point_blocks(16_777_216, 128, geo.pairs_per_block,
                                      card.point_resident(torch.float32, 1), card.sms)
    assert blocks < -(-tss.point_chunk(16_777_216, 128, geo.pairs_per_block) // 256)


def test_bloated_plan_fixture_exceeds_a_mock_shared_memory_budget():
    mod = _load_fixture("bloated_plan")
    prob = kernel_audit.Problem(N=4096 * 33, M=256, Q=4, D=1)
    ok = kernel_audit.audit_plan("bloated", mod.bloated_plan, problem=prob)
    assert ok.fits and not ok.findings
    assert ok.smem_bytes == 4 * (128 * 256 + 256 * 4)  # the whole tile resident
    bad = kernel_audit.audit_plan("bloated", mod.bloated_plan, problem=prob,
                                  smem_budget_bytes=64 * 1024)
    assert [f.code for f in bad.findings] == ["SMEM001"]
    assert not bad.fits


def test_audit_flags_splits_that_drop_points():
    mod = _load_fixture("bloated_plan")
    a = kernel_audit.audit_plan("bloated", mod.bloated_plan,
                                problem=kernel_audit.Problem(N=100_003, M=64, Q=1, D=1))
    assert [f.code for f in a.findings] == ["COVER001"]
    assert "uncovered" in a.findings[0].message or "not [0, 100003)" in a.findings[0].message


def test_audit_refuses_what_shared_memory_cannot_hold():
    a = kernel_audit.audit_kernel("kfu_pallas", problem=kernel_audit.Problem(64, 8, 4096, 1))
    assert [f.code for f in a.findings] == ["PLAN001"]


def test_audit_holds_the_half_precision_rule(monkeypatch):
    """Half inputs run through the float32 entries; a promotion that kept
    them in half would have no entry."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(ops, "_compute_dtype", lambda dt: dt)
    a = kernel_audit.audit_kernel("suffstats_pallas")
    assert {f.code for f in a.findings} == {"DTYPE001"}
    assert len(a.findings) == 2  # bfloat16 and float16


def test_ptxas_report_parses_into_resources():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11pair_kernelIfLi1EEvPKT_S2_' for 'sm_90a'
ptxas info    : Function properties for _Z11pair_kernelIfLi1EEvPKT_S2_
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 76 registers, used 1 barriers, 256 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z12point_kernelIdLi0ELb1EEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _Z12point_kernelIdLi0ELb1EEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 400 bytes cmem[0]
"""
    rows = kernel_audit.parse_ptxas(report)
    assert rows == [
        {"instance": "pair_kernel<float, 1>", "registers": 76, "stack_frame": 8,
         "spill_stores": 8, "spill_loads": 16, "lmem": 0, "smem_static": 256, "barriers": 1},
        {"instance": "point_kernel<double, 0, true>", "registers": 128, "stack_frame": 0,
         "spill_stores": 0, "spill_loads": 0, "lmem": 0, "smem_static": 0, "barriers": 0}]


def test_kernel_table_rows_are_json_ready():
    audits = kernel_audit.audit_kernels(problem=kernel_audit.Problem(N=2048, M=256, Q=4, D=2))
    rows = kernel_audit.kernel_table(audits)
    assert len(rows) == 2 * len(kernel_audit.KERNELS)
    for row in rows:
        assert row["section"] == "kernel_audit" and row["fits"] is True
        assert row["smem_bytes"] <= row["smem_budget_bytes"]
        assert row["passes"] and all(p["block"] == 256 for p in row["passes"])
    json.dumps(rows)  # must serialize as-is


# ---------------------------------------------------------------------------
# repo lint
# ---------------------------------------------------------------------------

def test_clean_tree_lints_clean():
    assert lint.lint_paths() == []


def test_import_time_dispatch_fixture_flags_exactly_anl001():
    src = (FIXTURES / "import_time_dispatch.py").read_text()
    findings = lint.lint_source(src, "repro_torch/seeded/import_time_dispatch.py")
    assert [f.code for f in findings] == ["ANL001"]
    assert findings[0].line == 7  # the module-scope is_available() call
    assert "import time" in findings[0].message
    assert "7" in findings[0].describe()


def test_anl002_generalized_registry_access_outside_lock():
    src = (
        "class S:\n"
        "    def __init__(self):\n"
        "        self._models = {}\n"          # exempt: __init__
        "    def put(self, k, v):\n"
        "        with self._registry_lock:\n"
        "            self._models[k] = v\n"    # guarded write: tracked
        "    def bad(self, k):\n"
        "        return self._models[k]\n"     # ANL006
        "    def good(self, k):\n"
        "        with self._registry_lock:\n"
        "            return self._models[k]\n"
    )
    findings = lint.lint_source(src, "repro_torch/serve/server.py")
    assert [(f.code, f.line) for f in findings] == [("ANL006", 8)]
    assert "_registry_lock" in findings[0].message
    suppressed = src.replace("return self._models[k]\n    def good",
                             "return self._models[k]  # noqa: ANL002\n"
                             "    def good")
    assert lint.lint_source(suppressed, "repro_torch/serve/server.py") == []


def test_anl003_autograd_registration_outside_dispatcher():
    src = ("import torch\n"
           "class Op(torch.autograd.Function):\n"
           "    pass\n"
           "torch.library.register_autograd('x::op', bwd)\n"
           "_, vjp = torch.func.vjp(f, x)\n")
    findings = lint.lint_source(src, "repro_torch/kernels/rogue.py")
    assert [(f.code, f.line) for f in findings] == [("ANL003", 2), ("ANL003", 4),
                                                    ("ANL003", 5)]
    # the same source is fine outside kernel files and in the dispatcher
    assert lint.lint_source(src, "repro_torch/core/psi_stats.py") == []
    assert lint.lint_source(src, "repro_torch/kernels/ops.py") == []


def test_anl004_literal_dtypes_only_in_kernel_files_outside_helpers():
    src = (
        "import torch\n"
        "def k(x):\n"
        "    return x.new_zeros(3, dtype=torch.float32)\n"   # ANL004
        "def _promote_acc():\n"
        "    return torch.float64\n"                         # exempt
        "def j(x):\n"
        "    return x.to(torch.bfloat16)\n"                  # ANL004
        "def h(x):\n"
        "    return x.double()\n"                            # ANL004
        "def _compute_dtype(dt):\n"
        "    return torch.float32 if dt == torch.float16 else dt\n"  # exempt
        "ENTRIES = {torch.float32: 'f32', torch.float64: 'f64'}\n"  # read only
        "def flag(dt):\n"
        "    return int(dt == torch.float64)\n"              # read only
        "def acc(x):\n"
        "    return x.new_empty(4, dtype=torch.float64)\n"   # accumulator
        "def s(x):\n"
        "    return torch.ones(4, dtype='float32')\n"        # ANL004
        "def w(x):\n"
        "    return x.to(torch.float64)\n"                   # ANL004
    )
    findings = lint.lint_source(src, "repro_torch/kernels/rogue.py")
    assert [(f.code, f.line) for f in findings] == [("ANL004", 3), ("ANL004", 7),
                                                    ("ANL004", 9), ("ANL004", 18),
                                                    ("ANL004", 20)]
    assert lint.lint_source(src, "repro_torch/core/inference.py") == []


def test_noqa_suppresses_a_named_finding():
    src = "import torch\nN = torch.cuda.device_count()  # noqa: ANL001\n"
    assert lint.lint_source(src, "repro_torch/foo.py") == []
    src2 = "import torch\nN = torch.cuda.device_count()  # noqa: ANL002\n"
    assert [f.code for f in lint.lint_source(src2, "repro_torch/foo.py")] == ["ANL001"]
    # inside a function the same read happens at call time: no finding
    src3 = "import torch\ndef n():\n    return torch.cuda.device_count()\n"
    assert lint.lint_source(src3, "repro_torch/foo.py") == []


def test_syntax_errors_surface_as_findings_not_crashes():
    findings = lint.lint_source("def broken(:\n", "repro_torch/bad.py")
    assert [f.code for f in findings] == ["ANL000"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_lint_and_kernel_audit_pass_on_clean_tree(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--lint", "--kernel-audit"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "14 kernel instance(s) audited" in out


def test_cli_kernel_audit_fails_under_tiny_budget(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--kernel-audit", "--smem-budget", str(2 ** 12)]) > 0
    out = capsys.readouterr().out
    assert "SMEM001" in out and "FAIL" in out


def test_cli_lint_fails_on_seeded_fixture_with_file_and_line(capsys):
    from repro_torch.analysis.__main__ import main

    fixture = FIXTURES / "import_time_dispatch.py"
    assert main(["--lint", str(fixture)]) == 1
    out = capsys.readouterr().out
    assert "import_time_dispatch.py:7: ANL001" in out


def test_cli_all_passes_clean_on_the_port(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--all", "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is True and set(doc["passes"]) == {
        "lint", "concurrency", "kernel_audit", "trace_check"}
    assert len(doc["passes"]["trace_check"]["checks"]) == 6
