"""The port's step program (``runtime/step_program.py``) against the JAX
package's, on the CPU: stage for stage the same names, dataflow, kinds and
``describe()``; the same dangling and duplicate programs rejected; the
fused form bit for bit ``make_train_step``; and the declared ZeRO specs of
the TrainState on a 16 x 16 mesh spec for spec the reference's (what the
reference's ``test_program_declares_zero_specs`` checks, without its
pre-0.9 mesh constructor)."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import RLConfig as JRLConfig
from repro.runtime import step_program as jsp
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import RLConfig
from repro_torch.core.train_step import init_train_state, make_train_step
from repro_torch.data.checkpoint import _flatten_with_path
from repro_torch.data.trajectory import dummy_batch
from repro_torch.runtime import step_program as tsp
from repro_torch.sharding.rules import AbstractMesh
from repro_torch.tree import tree_leaves

JCFG = jreduced(jget_config("deepseek-7b"), layers=2, d_model=64)
CFG = reduced(get_config("deepseek-7b"), layers=2, d_model=64)


@pytest.fixture(autouse=True)
def _deterministic():
    """The CPU's ``index_put_`` with accumulate (the embedding table's
    backward) adds in parallel in no fixed order, so two runs of one step
    may differ in the last bit; bit-for-bit comparisons take its
    deterministic form."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _stages(prog):
    return [(s.name, s.inputs, s.outputs, s.kind, s.per_micro,
             s.init is not None, s.fn is not None) for s in prog.stages]


@pytest.mark.parametrize("kw", [{}, {"grad_accum": 3},
                                {"grad_accum": 2, "fused_loss": False}])
def test_program_stages_and_describe_equal_reference(kw):
    want = jsp.build_train_step_program(JCFG, JRLConfig(**kw))
    got = tsp.build_train_step_program(CFG, RLConfig(**kw), device="cpu")
    assert _stages(got) == _stages(want)
    assert (got.name, got.inputs, got.n_micro) == (want.name, want.inputs,
                                                   want.n_micro)
    assert got.describe().splitlines() == want.describe().splitlines()
    got = tsp.build_train_step_program(CFG, RLConfig(**kw), n_micro=5,
                                       device="cpu")
    assert got.n_micro == 5 and "(K=5;" in got.describe()
    with pytest.raises(KeyError) as t_err:
        got.stage("nope")
    with pytest.raises(KeyError) as j_err:
        want.stage("nope")
    assert str(t_err.value).split(";")[0] == str(j_err.value).split(";")[0]


@pytest.mark.parametrize("stages", [
    (("s1", ("a", "ghost"), ("b",)),),                      # dangling
    (("s1", ("a",), ("b",)), ("s1", ("b",), ("c",))),       # duplicate
    (("s1", ("a",), ("b",)), ("s2", ("c",), ("d",))),       # dangling later
])
def test_validation_rejects_what_the_reference_rejects(stages):
    def build(mod):
        return mod.StepProgram(name="bad", inputs=("a",), stages=tuple(
            mod.StageSpec(n, inputs=i, outputs=o) for n, i, o in stages))
    with pytest.raises(ValueError) as j_err:
        build(jsp)
    with pytest.raises(ValueError) as t_err:
        build(tsp)
    assert str(t_err.value) == str(j_err.value)


def _bits_equal(a, b) -> bool:
    fa, fb = list(_flatten_with_path(a)), list(_flatten_with_path(b))
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("fused_loss", [True, False])
def test_fused_form_equals_make_train_step(fused_loss):
    rl = RLConfig(grad_accum=2, fused_loss=fused_loss, lr_policy=1e-4,
                  lr_value=1e-3)
    batch = dummy_batch(4, 4, 12, CFG.action_dim, CFG.vocab_size,
                        CFG.action_vocab_size, seed=7)
    s1, m1 = make_train_step(CFG, rl, device="cpu")(
        init_train_state(CFG, 0, device="cpu"), batch)
    prog = tsp.build_train_step_program(CFG, rl, device="cpu")
    s2, m2 = prog.fused(donate=False)(init_train_state(CFG, 0, device="cpu"),
                                      batch)
    assert _bits_equal(s1, s2)
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v) for k, v in m2.items()}
    assert int(s2.version) == 1


@pytest.mark.parametrize("arch", ["deepseek-7b", "openvla-7b"])
def test_train_state_specs_equal_reference(arch):
    """optim_update's declared state specs on a 16 x 16 mesh: params under
    the TP rules, moments additionally over ``data`` where an axis
    divides, scalars replicated — the reference's, spec for spec."""
    jcfg = jreduced(jget_config(arch), layers=2, d_model=64)
    tcfg = reduced(get_config(arch), layers=2, d_model=64)
    want = jsp.build_train_step_program(
        jcfg, JRLConfig(), mesh=JAbstractMesh((16, 16), ("data", "model"))
    ).stage("optim_update").specs["state"]
    got = tsp.build_train_step_program(
        tcfg, RLConfig(), mesh=AbstractMesh((16, 16), ("data", "model")),
        device="cpu").stage("optim_update").specs["state"]
    assert set(got) == set(want) == {"params", "moments", "scalars"}
    assert tuple(got["scalars"]) == tuple(want["scalars"]) == ()
    for key in ("params", "moments"):
        w = [tuple(s) for s in jax.tree.leaves(
            want[key], is_leaf=lambda x: isinstance(x, JP))]
        assert [tuple(s) for s in tree_leaves(got[key])] == w, key
    n_zero = sum(1 for p, m in zip(tree_leaves(got["params"]),
                                   tree_leaves(got["moments"]))
                 if m != p and "data" in m)
    assert n_zero > 0
    assert tsp.build_train_step_program(tcfg, RLConfig(), device="cpu") \
        .stage("optim_update").specs is None
