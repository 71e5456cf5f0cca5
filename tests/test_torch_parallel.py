"""The port's multi-device layer on gloo, against the JAX package.

One module-scoped fixture runs two CPU jobs of `tests/torch_parallel_worker.py`
(4 processes, then 2), each rank on its own blocks of the same numpy inputs,
over a ``file://`` store under the test's temporary directory.  The 4-rank
job also runs the (2, 2) batch x chunk mesh, writes a checkpoint from every
rank and loads one the JAX package wrote from 8 devices; the 2-rank job
resumes the 4-rank checkpoint.  Every rank runs `parallel.dryrun.run()`.

Each case gathers the ranks' blocks of one result and holds them, bit for
bit, to the JAX package's one-device oracle (`core.mul_chunks`,
`decrypt_parity`, `permute_benes.apply_benes`, the counter-engine encrypt)
and to `csgn_tpu.parallel` on the conftest's 8-device virtual CPU mesh.  The
two jobs cost about 10 s of wall time in 6 processes.  Tolerance: exact.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import csgn_tpu as J
from csgn_tpu import io as jio
from csgn_tpu import parallel as jpar
from csgn_tpu import pipeline as jpipe
from csgn_tpu.ops import core as jcore
from csgn_tpu.ops import permute_benes as jpb

REPO = pathlib.Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"
N, D, SEED = 95, 4, 1234
WORLDS = (2, 4)
T1, T2, T3, ODD, BITS = 8, 12, 3, 7, 16   # t1, t2 divide both worlds; 3 and 7 do not


def _inputs() -> dict:
    ctx = J.Context(N, D)
    rng = np.random.default_rng(SEED)
    key = rng.choice(N, D, replace=False).astype(np.int32)
    mask = np.asarray(J.SecretKey(ctx, key).mask)

    def words(*shape):
        w = rng.integers(0, 2**32, (*shape[:-1], ctx.words32, shape[-1]), dtype=np.uint32)
        return w & ctx.valid_mask[:, None]

    a, b = words(T1), words(T2)
    a[:, 0:T1:3] |= mask[:, None]      # 3 matching a-chunks x 3 matching b-chunks
    b[:, 0:T2:5] |= mask[:, None]
    wb = words(4, 4)
    wb[:, :, 0] |= mask
    return {"key": key, "a": a, "b": b, "b3": words(T3), "odd": words(ODD), "wb": wb,
            "bits": rng.integers(0, 2, BITS).astype(np.int32),
            "perm": rng.permutation(N).astype(np.int32)}


INPUTS = _inputs()


def _run_world(world: int, case: pathlib.Path) -> list[dict]:
    outdir = case / f"out{world}"
    outdir.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(case / f"store{world}"),
         str(outdir), str(case)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"rank {r} rc {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    assert not errors, "\n".join(errors)
    return [dict(np.load(outdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [rank results]}, and the case directory."""
    case = tmp_path_factory.mktemp("parallel")
    np.savez(case / "inputs.npz", **INPUTS)
    (case / "meta.json").write_text(json.dumps({"n": N, "d": D, "seed": SEED}))
    ctx = J.Context(N, D)
    prod = jcore.mul_chunks(jnp.asarray(INPUTS["a"]), jnp.asarray(INPUTS["b"]))
    jio.save_state_sharded(case / "jax", {
        "prod": jpar.shard_ciphertext(J.Ciphertext(prod, ctx), jpar.chunk_mesh(8)),
        "sk": J.SecretKey(ctx, INPUTS["key"])})
    out = {4: _run_world(4, case)}     # writes case/torch4, which the 2-rank job resumes
    out[2] = _run_world(2, case)
    return out, case


def _cat(ranks: list[dict], key: str) -> np.ndarray:
    return np.concatenate([r[key] for r in ranks], axis=-1)


@functools.cache
def _oracle() -> dict:
    """The one-device results (JAX package)."""
    ctx = J.Context(N, D)
    sk = J.SecretKey(ctx, INPUTS["key"])
    a, b, b3 = (jnp.asarray(INPUTS[k]) for k in ("a", "b", "b3"))
    mask = jnp.asarray(sk.mask)
    prod = jcore.mul_chunks(a, b)
    chain = jcore.mul_chunks(prod, b3)
    plan = J.Permutation(INPUTS["perm"]).benes_plan()
    wb = jnp.asarray(INPUTS["wb"])
    prod_b = jcore.mul_chunks(wb, wb)
    return {
        "encrypt": np.asarray(sk.encrypt_batch(jnp.asarray(INPUTS["bits"]), SEED,
                                               engine="counter")),
        "allgather": np.asarray(prod), "ring": np.asarray(prod), "mul_decrypt": np.asarray(prod),
        "broadcast": np.asarray(jcore.mul_chunks(a, b3)),
        "parity": int(jcore.decrypt_parity(prod, mask)),
        "permute": np.asarray(jpb.apply_benes(prod, plan)),
        "chain": np.asarray(chain), "chain_parity": int(jcore.decrypt_parity(chain, mask)),
        "mul_batch": np.asarray(prod_b),
        "decrypt_batch": np.asarray(jcore.decrypt_parity(prod_b, mask)),
        "permute_batch": np.asarray(jpb.apply_benes(prod_b, plan)),
    }


@functools.cache
def _jax_parallel(world: int) -> dict:
    """The same ops through `csgn_tpu.parallel` on `world` virtual devices."""
    ctx = J.Context(N, D)
    sk = J.SecretKey(ctx, INPUTS["key"])
    mesh = jpar.chunk_mesh(world)
    a, b, b3 = (jnp.asarray(INPUTS[k]) for k in ("a", "b", "b3"))
    mask = jnp.asarray(sk.mask)
    prod = jpar.sharded_mul_allgather(a, b, mesh)
    fused, parity = jpar.sharded_mul_decrypt(a, b, mask, mesh)
    cts = [J.Ciphertext(x, ctx) for x in (a, b, b3)]
    chain_d, chain_p = jpipe.mul_chain_sharded_decrypt(cts, sk, mesh)
    out = {
        "allgather": np.asarray(prod), "ring": np.asarray(jpar.sharded_mul_ring(a, b, mesh)),
        "broadcast": np.asarray(jpar.sharded_mul_broadcast(a, b3, mesh)),
        "mul_decrypt": np.asarray(fused), "parity": int(parity),
        "decrypt_parity": int(jpar.sharded_decrypt_parity(prod, mask, mesh)),
        "permute": np.asarray(jpar.sharded_permute(
            prod, J.Permutation(INPUTS["perm"]).benes_plan(), mesh)),
        "chain": np.asarray(jpipe.mul_chain_sharded(cts, mesh).wt),
        "chain_decrypt": np.asarray(chain_d.wt), "chain_parity": int(chain_p),
        "shard_odd": np.asarray(jpar.shard_ciphertext(
            J.Ciphertext(jnp.asarray(INPUTS["odd"]), ctx), mesh).wt),
    }
    if world == 4:
        mesh2 = jpar.batch_chunk_mesh(2, 2)
        wb = jpar.shard_batch(jnp.asarray(INPUTS["wb"]), mesh2)
        pb2 = jpar.sharded_mul_batch(wb, wb, mesh2)
        out["mul_batch"] = np.asarray(pb2)
        out["decrypt_batch"] = np.asarray(jpar.sharded_decrypt_batch(pb2, mask, mesh2))
        out["permute_batch"] = np.asarray(jpar.sharded_permute_batch(
            pb2, J.Permutation(INPUTS["perm"]).benes_plan(), mesh2))
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["allgather", "ring", "mul_decrypt", "broadcast", "permute",
                                  "chain", "chain_decrypt"])
def test_sharded_words_equal_the_oracle_and_the_jax_layer(worlds, world, name):
    """The ranks' blocks, in rank order, are the one-device product (or its
    permutation, or the chain), and csgn_tpu.parallel's global array."""
    got = _cat(worlds[0][world], name)
    o = _oracle()
    want = {"permute": o["permute"], "broadcast": o["broadcast"], "chain": o["chain"],
            "chain_decrypt": o["chain"]}.get(name, o["allgather"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_parallel(world)[name])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["mul_decrypt_parity", "decrypt_parity", "chain_decrypt_parity"])
def test_sharded_parities_are_the_same_on_every_rank(worlds, world, name):
    got = {int(r[name][0]) for r in worlds[0][world]}
    o, jp = _oracle(), _jax_parallel(world)
    want = o["chain_parity"] if name.startswith("chain") else o["parity"]
    jwant = {"mul_decrypt_parity": jp["parity"], "decrypt_parity": jp["decrypt_parity"],
             "chain_decrypt_parity": jp["chain_parity"]}[name]
    assert got == {want} == {jwant}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["encrypt", "encrypt_invariant"])
def test_sharded_encrypt_is_the_one_device_encrypt(worlds, world, name):
    """Both names give each rank the one-device counter-engine encrypt's
    columns of its block (col0 = rank * block), on any number of ranks."""
    np.testing.assert_array_equal(_cat(worlds[0][world], name), _oracle()["encrypt"])


@pytest.mark.parametrize("world", WORLDS)
def test_shard_ciphertext_pads_to_the_axis(worlds, world):
    got = _cat(worlds[0][world], "shard_odd")
    want = np.pad(INPUTS["odd"], ((0, 0), (0, -ODD % world)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_parallel(world)["shard_odd"])


@pytest.mark.parametrize("world", WORLDS)
def test_dryrun_passes_at_every_rank(worlds, world):
    """`parallel.dryrun.run()` (which raises on any mismatch) finished on
    every rank, with its parity 1."""
    assert [int(r["dryrun_parity"][0]) for r in worlds[0][world]] == [1] * world


def _grid(ranks: list[dict], key: str) -> np.ndarray:
    """Blocks of a (2, 2) mesh reassembled: "b" along axis 0, "c" along -1."""
    rows = {}
    for r in ranks:
        i, j = (int(x) for x in r["mesh2_coord"])
        rows.setdefault(i, {})[j] = r[key]
    return np.concatenate([np.concatenate([rows[i][j] for j in sorted(rows[i])], axis=-1)
                           if rows[i][0].ndim > 1 else rows[i][0] for i in sorted(rows)],
                          axis=0)


@pytest.mark.parametrize("name", ["mul_batch", "decrypt_batch", "permute_batch"])
def test_batch_chunk_mesh_ops(worlds, name):
    """The (2, 2) mesh's blocks reassemble to the one-device batched result
    and to csgn_tpu.parallel's on a (2, 2) virtual mesh; the decrypt bits of
    the two ranks of a "c" line agree."""
    ranks = worlds[0][4]
    got = _grid(ranks, name)
    np.testing.assert_array_equal(got, _oracle()[name].astype(got.dtype))
    np.testing.assert_array_equal(got, _jax_parallel(4)[name].astype(got.dtype))
    if name == "decrypt_batch":
        lines = {}
        for r in ranks:
            lines.setdefault(int(r["mesh2_coord"][0]), []).append(r[name].tolist())
        assert all(v[0] == v[1] for v in lines.values())


def test_checkpoint_from_eight_jax_devices_loads_on_four_ranks(worlds):
    np.testing.assert_array_equal(_cat(worlds[0][4], "load_jax"), _oracle()["allgather"])


def test_checkpoint_from_four_ranks_resumes_on_two(worlds):
    np.testing.assert_array_equal(_cat(worlds[0][2], "load_torch4"), _oracle()["allgather"])


def test_checkpoint_from_four_ranks_loads_in_the_jax_package(worlds):
    """The 4-rank directory has the JAX package's format: its loader reads
    it whole and onto an 8-device mesh."""
    case = worlds[1]
    manifest = json.loads((case / "torch4" / "manifest.json").read_text())
    assert [b[:2] for b in manifest["entries"]["prod"]["blocks"]] == \
        [[i * T1 * T2 // 4, T1 * T2 // 4] for i in range(4)]
    state = jio.load_state_sharded(case / "torch4")
    np.testing.assert_array_equal(np.asarray(state["prod"].wt), _oracle()["allgather"])
    np.testing.assert_array_equal(state["sk"].indices, INPUTS["key"])
    resharded = jio.load_state_sharded(case / "torch4", mesh=jpar.chunk_mesh(8))
    np.testing.assert_array_equal(np.asarray(resharded["prod"].wt), _oracle()["allgather"])
