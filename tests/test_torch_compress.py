"""int8 gradient compression (``optim/compress.py``) against the reference.

- ``quantize_int8`` / ``dequantize_int8``: bitwise the reference's, over
  float32 and bfloat16 inputs, zeros, ties at half an int8 step (both
  packages round half to even) and values at the clip;
- ``ef_init`` and the error feedback of one pod over three steps against
  the reference's ``compressed_pod_allreduce`` in a one-device
  ``shard_map``: payloads bitwise, means rtol 1e-6, new buffers within
  two float32 steps of each step's largest |g + ef| (``_ef_atol``);
- ``compressed_pod_allreduce`` on 2 gloo ranks (subprocesses meeting
  through a ``FileStore`` in ``tmp_path``) against the reference's
  ``shard_map`` on 2 forced CPU devices, two steps: each rank's int8
  payload equal to the reference's, the means at rtol 1e-6 (atol 1e-6 of
  the leaf's largest entry: the float32 mean of the dequantized payloads
  may round differently in the last place), the new error feedback as
  above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ranks import run_sides
from repro.optim import compress as jc
from repro_torch.optim import compress as tc

SHAPES = {"a": (64, 32), "b": (7,), "c": (3, 5, 4)}
STEPS = 2


MAGNITUDE = {"a": 1e-5, "b": 3.0, "c": 2e-2}   # per leaf, as in training


def _grads(seed: int, pod: int = 0) -> dict:
    rng = np.random.default_rng([seed, pod])
    return {k: (rng.standard_normal(s) * MAGNITUDE[k]).astype(np.float32)
            for k, s in SHAPES.items()}


def _ef_atol(gs) -> float:
    """The error-feedback tolerance after the steps with gradients ``gs``:
    two float32 steps of each step's largest |g + ef|, summed.  Jitted,
    the reference forms ``q * scale`` with a scale rounded otherwise than
    its quantizer's (up to 127 steps of the scale: one step of the largest
    entry) and fuses the product into the subtraction; the port rounds the
    product once.  Each step's difference carries into the next buffer."""
    total = amax = 0.0
    for g in gs:
        amax = float(np.abs(g).max()) + amax / 254   # |ef| <= scale / 2
        total += 2 * float(np.finfo(np.float32).eps) * amax
    return total


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


CASES = {
    "normal": np.random.default_rng(0).standard_normal((33, 17)),
    "tiny": np.random.default_rng(1).standard_normal(100) * 1e-30,
    "zeros": np.zeros(16),
    # x / scale lands on k + 0.5 for the entries 0.5, 1.5, ..., 126.5
    "ties": np.concatenate([np.arange(127) + 0.5, [127.0]]),
    "clip": np.array([-127.0, 127.0, -126.5, 3.0]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_quantize_dequantize_bitwise(case, dtype):
    x = jnp.asarray(CASES[case], jnp.dtype(dtype))
    t = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jc.quantize_int8(x)
    q, s = tc.quantize_int8(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(tc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jc.dequantize_int8(jq, js)))
    if case == "ties":
        # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert q[:3].tolist() == [0, 2, 2]


def test_ef_init_zero_float32_like_grads():
    g = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
         "n": {"b": torch.ones(4)}, "l": [torch.ones(2)]}
    ef = tc.ef_init(g)
    assert ef["w"].dtype == torch.float32 and ef["w"].shape == (3, 2)
    assert not ef["w"].any() and ef["n"]["b"].shape == (4,)
    assert ef["l"][0].shape == (2,)


def test_error_feedback_one_pod_matches_reference():
    """Three steps on one pod: the payload is quantize(g + ef), the mean
    its dequantized value and the buffer the rest, as in the reference."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("pod",))
    P = jax.sharding.PartitionSpec
    run = jax.jit(jax.shard_map(
        lambda g, e: jc.compressed_pod_allreduce(g, e, "pod"), mesh=mesh,
        in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False))
    jef = jc.ef_init(_grads(0))
    ef = tc.ef_init(_to_torch(_grads(0)))
    for step in range(3):
        g = _grads(step)
        for k in SHAPES:
            q, s = tc.quantize_int8(torch.from_numpy(g[k]) + ef[k])
            jq, _ = jc.quantize_int8(g[k] + jef[k])
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        prev = {k: v.clone() for k, v in ef.items()}
        javg, jef = run(g, jef)
        avg, ef = tc.compressed_pod_allreduce(_to_torch(g), ef)
        for k in SHAPES:
            g32 = torch.from_numpy(g[k]) + prev[k]
            deq = tc.dequantize_int8(*tc.quantize_int8(g32))
            assert torch.equal(avg[k], deq) and torch.equal(ef[k], g32 - deq)
            np.testing.assert_allclose(
                ef[k].numpy(), np.asarray(jef[k]), rtol=0,
                atol=_ef_atol([_grads(j)[k] for j in range(step + 1)]))
            np.testing.assert_allclose(avg[k].numpy(), np.asarray(javg[k]),
                                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# Two pods
# ---------------------------------------------------------------------------


def ref_main(out_path: str) -> None:
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    assert jax.device_count() == 2
    mesh = Mesh(np.array(jax.devices()), ("pod",))
    run = jax.jit(jax.shard_map(
        lambda g, e: jc.compressed_pod_allreduce(
            jax.tree.map(lambda x: x[0], g), jax.tree.map(lambda x: x[0], e),
            "pod"),
        mesh=mesh, in_specs=(P("pod"), P("pod")),
        out_specs=(P(), P("pod")), check_vma=False))
    stack = lambda trees: {k: np.stack([t[k] for t in trees])
                           for k in SHAPES}
    ef = stack([jax.tree.map(np.asarray, jc.ef_init(_grads(0)))] * 2)
    res = {}
    for step in range(STEPS):
        g = stack([_grads(step, pod) for pod in range(2)])
        for pod in range(2):
            for k in SHAPES:
                q, s = jc.quantize_int8(jnp.asarray(g[k][pod] + ef[k][pod]))
                res[f"{step}/q/{pod}/{k}"] = np.asarray(q)
        avg, new_ef = run(g, ef)
        ef = {k: np.asarray(v).reshape((2,) + SHAPES[k])
              for k, v in new_ef.items()}
        for k in SHAPES:
            res[f"{step}/avg/{k}"] = np.asarray(avg[k])
            for pod in range(2):
                res[f"{step}/ef/{pod}/{k}"] = ef[k][pod]
    np.savez(out_path, **res)


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = make_mesh((world,), ("pod",), "cpu")
    ef = tc.ef_init(_to_torch(_grads(0)))
    res = {}
    for step in range(STEPS):
        g = _to_torch(_grads(step, rank))
        for k in SHAPES:
            res[f"{step}/q/{k}"] = tc.quantize_int8(g[k] + ef[k])[0].numpy()
        avg, ef = tc.compressed_pod_allreduce(g, ef, mesh.get_group("pod"))
        for k in SHAPES:
            res[f"{step}/avg/{k}"] = avg[k].numpy()
            res[f"{step}/ef/{k}"] = ef[k].numpy()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_pods(tmp_path_factory):
    return run_sides(tmp_path_factory.mktemp("pods"), "test_torch_compress",
                     2, 2, timeout=240)


@pytest.mark.parametrize("step", range(STEPS))
def test_two_pod_payloads_equal_reference(two_pods, step):
    ref, ranks = two_pods
    for pod, got in enumerate(ranks):
        for k in SHAPES:
            np.testing.assert_array_equal(got[f"{step}/q/{k}"],
                                          ref[f"{step}/q/{pod}/{k}"])


@pytest.mark.parametrize("step", range(STEPS))
def test_two_pod_means_and_feedback_match_reference(two_pods, step):
    ref, ranks = two_pods
    for pod, got in enumerate(ranks):
        for k in SHAPES:
            want = ref[f"{step}/avg/{k}"]
            np.testing.assert_allclose(
                got[f"{step}/avg/{k}"], want, rtol=1e-6,
                atol=1e-6 * float(np.abs(want).max()), err_msg=f"avg {k}")
            np.testing.assert_allclose(
                got[f"{step}/ef/{k}"], ref[f"{step}/ef/{pod}/{k}"], rtol=0,
                atol=_ef_atol([_grads(j, pod)[k] for j in range(step + 1)]),
                err_msg=f"ef {k}")
