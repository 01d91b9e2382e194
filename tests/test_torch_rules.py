"""Rules the port keeps: it imports neither JAX, nor the JAX package, nor
``ml_dtypes`` (checked after importing every module, the transport,
checkpoint and distribution ones included; the telemetry module and the
fault injector load only when ``REPRO_TRACE`` / ``REPRO_FAULTS`` ask), its
copied configs equal the reference's, the bridge carries bf16 bit-exactly,
its entry points default to CUDA, and its inference service serves on the
CPU across a drain swap."""
import dataclasses
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.models.policy import init_policy_params as j_init_policy_params
from repro_torch.bridge import params_from_numpy, params_to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro.")
             or m == "ml_dtypes" or m.startswith("ml_dtypes."))
missing = [m for m in ("repro_torch.kernels.ops",
                       "repro_torch.kernels.gipo_loss",
                       "repro_torch.models.transformer",
                       "repro_torch.models.moe",
                       "repro_torch.envs.toy_manipulation",
                       "repro_torch.core.resampler",
                       "repro_torch.data.replay",
                       "repro_torch.data.prefetch",
                       "repro_torch.runtime.experience",
                       "repro_torch.runtime.rollout",
                       "repro_torch.runtime.trainer",
                       "repro_torch.runtime.scheduler",
                       "repro_torch.runtime.orchestrator",
                       "repro_torch.wm",
                       "repro_torch.wm.denoiser",
                       "repro_torch.wm.reward",
                       "repro_torch.wm.imagination",
                       "repro_torch.wm.wm_system",
                       "repro_torch.data.checkpoint",
                       "repro_torch.runtime.weight_store",
                       "repro_torch.runtime.transport",
                       "repro_torch.runtime.transport.codec",
                       "repro_torch.runtime.transport.ring",
                       "repro_torch.runtime.transport.channel",
                       "repro_torch.runtime.transport.server",
                       "repro_torch.runtime.transport.weights",
                       "repro_torch.runtime.transport.remote",
                       "repro_torch.runtime.transport.supervision",
                       "repro_torch.runtime.transport.resilience",
                       "repro_torch.runtime.transport.inference_plane",
                       "repro_torch.runtime.transport.faults",
                       "repro_torch.runtime.telemetry",
                       "repro_torch.launch",
                       "repro_torch.launch.worker",
                       "repro_torch.launch.mesh",
                       "repro_torch.sharding",
                       "repro_torch.sharding.rules",
                       "repro_torch.optim.zero",
                       "repro_torch.runtime.step_program",
                       "repro_torch.runtime.pipeline_exec",
                       "repro_torch.launch.steps",
                       "repro_torch.launch.train",
                       "repro_torch.launch.serve",
                       "repro_torch.launch.dryrun",
                       "repro_torch.roofline",
                       "repro_torch.roofline.analysis")
           if m not in sys.modules]
print(bad, missing)
sys.exit(1 if bad or missing else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT_UNGATED = r"""
import importlib, pkgutil, sys
sys.path.insert(0, "src")
import repro_torch
gated = ("repro_torch.runtime.telemetry",
         "repro_torch.runtime.transport.faults")
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    if m.name not in gated:
        importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in gated if m in sys.modules))
sys.exit(1 if any(m in sys.modules for m in gated) else 0)
"""


def test_trace_and_fault_modules_load_only_when_gated():
    """With ``REPRO_TRACE`` and ``REPRO_FAULTS`` unset, importing every
    other port module (and ``chip_smoke.py``) loads neither the telemetry
    module nor the fault injector: each hook site is one ``is None``
    check."""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT)}
    res = subprocess.run([sys.executable, "-c", _IMPORT_UNGATED], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_name_no_jax_import():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (f, s)
            assert not s.startswith(("import repro.", "from repro.",
                                     "from repro import")), (f, s)
            assert s != "import repro", (f, s)


@pytest.mark.parametrize("name", jconfigs.list_archs())
def test_configs_equal_reference(name):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    ref, port = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.head_dim == ref.head_dim
    assert port.param_count() == ref.param_count()
    assert dataclasses.asdict(tconfigs.reduced(port, layers=2, d_model=64)) \
        == dataclasses.asdict(jconfigs.reduced(ref, layers=2, d_model=64))


def test_runtime_and_rl_defaults_equal_reference():
    for cls in ("RuntimeConfig", "RLConfig", "WMConfig"):
        assert dataclasses.asdict(getattr(tconfigs, cls)()) == \
            dataclasses.asdict(getattr(jconfigs, cls)())


def test_bridge_round_trips_bf16_bit_exactly():
    cfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("openvla-7b"), layers=2,
                         d_model=64),
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        j_init_policy_params(cfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, device="cpu")
    assert tparams["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert tparams["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert tparams["value_head"]["mlp_w1"].dtype == torch.float32
    back = params_to_numpy(tparams)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tparams["embed"]["table"].float().numpy(),
        tree["embed"]["table"].astype(np.float32))


def test_bridge_round_trips_the_ssm_tree_bf16_bit_exactly():
    """mamba2's tree: bf16 matrices beside the f32 A_log, D and dt_bias
    leaves of every Mamba2 layer, carried as they stand."""
    cfg = dataclasses.replace(
        jconfigs.reduced(jconfigs.get_config("mamba2-2.7b"), layers=2,
                         d_model=64),
        param_dtype="bfloat16", compute_dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        j_init_policy_params(cfg, jax.random.PRNGKey(0)))
    tparams = params_from_numpy(tree, device="cpu")
    ssm = tparams["layers"]["ssm"]
    assert ssm["in_proj"].dtype == torch.bfloat16
    for name in ("A_log", "D", "dt_bias"):
        assert ssm[name].dtype == torch.float32 and ssm[name].shape == (2, 4)
    flat_a, tree_a = jax.tree.flatten(tree)
    flat_b, tree_b = jax.tree.flatten(params_to_numpy(tparams))
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(a.view(np.uint16),
                                          b.view(np.uint16))
        else:
            np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from repro_torch.bridge import batch_from_numpy
    from repro_torch.core.advnorm import init_adv_state
    from repro_torch.core.train_step import init_train_state, make_train_step
    from repro_torch.data.trajectory import dummy_batch
    from repro_torch.models import policy, transformer
    from repro_torch.data.prefetch import Prefetcher
    from repro_torch.runtime import (AcceRLSystem, FifoChannel,
                                     InferenceService, TrainerWorker,
                                     VersionedWeightStore)
    from repro_torch.bridge import wm_params_from_numpy
    from repro_torch.wm import (AcceRLWMSystem, ImaginationWorker,
                                WorldModelTrainer)
    from repro_torch.wm.imagination import make_imagine_fn
    from repro_torch.wm.wm_system import pretrain_world_model
    from repro_torch.runtime.transport import (InferencePlaneService,
                                               WeightStoreTransport)
    from repro_torch.data import checkpoint
    from repro_torch.runtime.transport import (TransportJournal,
                                               TransportServer)
    from repro_torch.runtime.transport.codec import encode_pytree
    from repro_torch.runtime.transport.resilience import RecoveredState
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.runtime.step_program import build_train_step_program
    from repro_torch.launch import serve, train
    checkpoint.save(str(tmp_path), 1, {"w": np.zeros(2, np.float32)})

    def resume_journal():
        server = TransportServer(
            journal=TransportJournal(tmp_path / "journal")).start()
        try:
            server.resume_from_journal()
        finally:
            server.stop()
            server.join()
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"), layers=2,
                           d_model=64)
    ssm_cfg = tconfigs.reduced(tconfigs.get_config("mamba2-2.7b"), layers=2,
                               d_model=64)
    hybrid_cfg = tconfigs.reduced(tconfigs.get_config("zamba2-1.2b"),
                                  layers=2, d_model=64)
    moe_cfg = tconfigs.reduced(tconfigs.get_config("granite-moe-1b-a400m"),
                               layers=2, d_model=64)
    from repro_torch.models import moe
    calls = [
        lambda: init_adv_state(),
        lambda: moe.moe_init(torch.Generator(), 64, moe_cfg.moe,
                             torch.float32),
        lambda: moe.stacked_moe_init(torch.Generator(), 2, 64, moe_cfg.moe,
                                     torch.float32),
        lambda: transformer.init_params(moe_cfg, torch.Generator()),
        lambda: transformer.init_decode_cache(moe_cfg, 1, 4),
        lambda: transformer.init_params(ssm_cfg, torch.Generator()),
        lambda: transformer.init_decode_cache(ssm_cfg, 1, 4),
        lambda: transformer.init_params(hybrid_cfg, torch.Generator()),
        lambda: transformer.init_decode_cache(hybrid_cfg, 1, 4),
        lambda: init_train_state(cfg),
        lambda: make_train_step(cfg, tconfigs.RLConfig()),
        lambda: batch_from_numpy(dummy_batch(1, 1, 1, 1, 8, 8)),
        lambda: policy.init_policy_params(cfg),
        lambda: policy.make_inference_fn(cfg),
        lambda: transformer.init_params(cfg, torch.Generator()),
        lambda: transformer.init_decode_cache(cfg, 1, 4),
        lambda: params_from_numpy({"w": np.zeros(2, np.float32)}),
        lambda: InferenceService(cfg, VersionedWeightStore(),
                                 tconfigs.RuntimeConfig()),
        lambda: TrainerWorker(cfg, tconfigs.RLConfig(),
                              tconfigs.RuntimeConfig(), FifoChannel(1),
                              VersionedWeightStore()),
        lambda: AcceRLSystem(cfg, tconfigs.RLConfig(),
                             tconfigs.RuntimeConfig()),
        lambda: Prefetcher(FifoChannel(1), 1, list, to_device=True),
        lambda: pretrain_world_model("spatial", tconfigs.WMConfig(),
                                     trajectories=1, train_steps=1, batch=1),
        lambda: make_imagine_fn(cfg, tconfigs.WMConfig()),
        lambda: ImaginationWorker(0, cfg, tconfigs.WMConfig(),
                                  VersionedWeightStore(), {}, FifoChannel(1),
                                  FifoChannel(1)),
        lambda: WorldModelTrainer(tconfigs.WMConfig(), {}, {},
                                  FifoChannel(1)),
        lambda: AcceRLWMSystem(cfg, tconfigs.RLConfig(),
                               tconfigs.RuntimeConfig(), tconfigs.WMConfig()),
        lambda: wm_params_from_numpy(
            {"obs": {"w": np.zeros(2, np.float32)},
             "reward": {"w": np.zeros(2, np.float32)}}),
        lambda: WeightStoreTransport(("127.0.0.1", 1)),
        lambda: InferencePlaneService(cfg, tconfigs.RuntimeConfig(),
                                      ("127.0.0.1", 1)),
        lambda: checkpoint.restore(str(tmp_path), {"w": torch.empty(
            2, device="meta")}),
        resume_journal,
        lambda: RecoveredState(store=(1, encode_pytree(
            {"w": np.zeros(2, np.float32)}))).store_params(),
        lambda: make_local_mesh(),
        lambda: make_mesh(1, 1),
        lambda: TrainerWorker(cfg, tconfigs.RLConfig(),
                              tconfigs.RuntimeConfig(pipeline=True),
                              FifoChannel(1), VersionedWeightStore()),
        lambda: build_train_step_program(cfg, tconfigs.RLConfig()),
        lambda: train.main(["--local", "--steps", "1"]),
        lambda: serve.main(["--local"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_inference_service_on_cpu_serves_across_a_drain_swap():
    from repro_torch.models.policy import init_policy_params
    from repro_torch.runtime import InferenceService, VersionedWeightStore
    cfg = dataclasses.replace(
        tconfigs.reduced(tconfigs.get_config("deepseek-7b"), layers=2,
                         d_model=64), num_prefix_tokens=1)
    rt = tconfigs.RuntimeConfig(num_inference_workers=1, inference_batch=4,
                                inference_max_wait_s=0.05)
    store = VersionedWeightStore()
    store.publish(init_policy_params(cfg, 0, device="cpu"), 0)
    service = InferenceService(cfg, store, rt, device="cpu").start()
    rng = np.random.default_rng(0)
    lock = threading.Lock()
    futures = []

    def client(n):
        for _ in range(n):
            fut = service.submit(
                rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
                rng.random(192).astype(np.float32), 3)
            with lock:
                futures.append(fut)

    try:
        threads = [threading.Thread(target=client, args=(n,))
                   for n in (3, 3, 2, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        first = [f.result(timeout=120) for f in list(futures)]
        params1 = init_policy_params(cfg, 1, device="cpu")
        store.begin_publish()          # drain: requests now wait
        client(4)
        store.publish(params1, 1)
        results = first + [f.result(timeout=120) for f in futures[10:]]
    finally:
        service.stop()
        service.join(timeout=10)
    assert len(results) == 14
    for r in results:
        assert r["actions"].shape == (cfg.action_dim,)
        assert r["actions"].min() >= 0
        assert r["actions"].max() < cfg.action_vocab_size
        assert np.isfinite(r["logp"]).all() and (r["logp"] <= 0).all()
        assert np.isfinite(r["value"])
    assert {r["policy_version"] for r in first} == {0}
    assert {r["policy_version"] for r in results[10:]} == {1}
    assert service.requests_served == 14
    assert service.weight_swaps == 2
    assert service.batches_run >= 2
    assert service.healthy


@pytest.mark.parametrize("side,served", [("port", 1), ("reference", 0)])
def test_publish_landing_while_a_window_is_carved(side, served):
    """A whole publish (drain flag raised and cleared) lands while the
    worker is carving a window. The reference swaps only on a drain flag it
    observes, so it serves that window on the old version 0 (ROADMAP queue
    C); the port diverges from it here and takes the newer version 1 before
    the batch starts."""
    if side == "port":
        from repro_torch.models.policy import init_policy_params
        from repro_torch.runtime import InferenceService, VersionedWeightStore
        cfgs, device = tconfigs, {"device": "cpu"}

        def init(cfg, seed):
            return init_policy_params(cfg, seed, device="cpu")
    else:
        from repro.models.policy import init_policy_params
        from repro.runtime import InferenceService, VersionedWeightStore
        cfgs, device = jconfigs, {}

        def init(cfg, seed):
            return init_policy_params(cfg, jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(
        cfgs.reduced(cfgs.get_config("deepseek-7b"), layers=2, d_model=64),
        num_prefix_tokens=1)
    # the window closes at 4 requests; T_max is far beyond the test's span
    rt = cfgs.RuntimeConfig(num_inference_workers=1, inference_batch=4,
                            inference_max_wait_s=60.0)
    store = VersionedWeightStore()
    store.publish(init(cfg, 0), 0)
    params1 = init(cfg, 1)
    service = InferenceService(cfg, store, rt, **device).start()
    rng = np.random.default_rng(0)

    def submit():
        return service.submit(
            rng.integers(0, cfg.vocab_size, 12).astype(np.int32),
            rng.random(192).astype(np.float32), 3)

    try:
        futures = [submit()]
        for _ in range(3000):           # the worker holds the first request
            if service._q.qsize() == 0:
                break
            threading.Event().wait(0.01)
        assert service._q.qsize() == 0
        store.begin_publish()
        store.publish(params1, 1)
        futures += [submit() for _ in range(3)]
        results = [f.result(timeout=120) for f in futures]
    finally:
        service.stop()
        service.join(timeout=10)
    assert service.healthy
    assert service.batches_run == 1
    assert [r["policy_version"] for r in results] == [served] * 4
