"""Checkpoints of the port (`csgn_tpu_torch.io`) against `csgn_tpu.io`: every
round trip, files and sharded directories crossing between the two packages
in both directions bit-equal, the JAX package's 8-block checkpoint of a
chunk-sharded payload, version errors and uneven block tables."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
import csgn_tpu_torch as T
from csgn_tpu import io as jio
from csgn_tpu_torch import io as tio
from csgn_tpu_torch.layout import words_to_numpy


def _words(ctx, chunks, seed, mask=None, forced=()):
    w = np.random.default_rng(seed).integers(0, 2**32, (ctx.words32, chunks), dtype=np.uint32)
    w &= ctx.valid_mask[:, None]
    if len(forced):
        w[:, list(forced)] |= mask[:, None]
    return w


def _pair(n, d, chunks, seed, forced=()):
    """The same key and ciphertext in both packages."""
    idx = np.random.default_rng(seed).choice(n, d, replace=False).astype(np.int32)
    jctx, tctx = J.Context(n, d), T.Context(n, d)
    jsk, tsk = J.SecretKey(jctx, idx), T.SecretKey(tctx, idx, device="cpu")
    w = _words(jctx, chunks, seed + 1, jsk.mask, forced)
    return (jsk, J.Ciphertext(jnp.asarray(w), jctx)), (tsk, T.Ciphertext.from_chunk_major(
        w.T, tctx, device="cpu")), w


def test_single_object_roundtrips(tmp_path):
    (_, _), (sk, ct), w = _pair(1247, 16, 9, 1, forced=(2,))
    p = T.Permutation(np.random.default_rng(2).permutation(1247))
    tio.save_ciphertext(tmp_path / "ct.npz", ct)
    tio.save_secret_key(tmp_path / "sk.npz", sk)
    tio.save_permutation(tmp_path / "p.npz", p)
    back = tio.load_ciphertext(tmp_path / "ct.npz", device="cpu")
    assert back.ctx == ct.ctx and np.array_equal(words_to_numpy(back.wt), w)
    bsk = tio.load_secret_key(tmp_path / "sk.npz", device="cpu")
    assert np.array_equal(bsk.indices, sk.indices) and np.array_equal(bsk.mask, sk.mask)
    assert int(bsk.decrypt(back)) == int(sk.decrypt(ct)) == 1
    assert tio.load_permutation(tmp_path / "p.npz") == p


def test_state_roundtrip_and_resume(tmp_path):
    ctx = T.Context(95, 4)
    sk = T.SecretKey(ctx, [3, 17, 40, 90], device="cpu")
    p = T.Permutation(np.random.default_rng(3).permutation(95))
    acc = (sk.encrypt(1, 1) + sk.encrypt(0, 2)) * (sk.encrypt(1, 3) + sk.encrypt(1, 4))
    tio.save_state(tmp_path / "state.npz", {"acc": acc, "sk": sk, "perm": p})
    state = tio.load_state(tmp_path / "state.npz", device="cpu")
    fresh = sk.encrypt(1, 5)
    done_a = (acc * fresh).apply_permutation(p)
    done_b = (state["acc"] * fresh).apply_permutation(state["perm"])
    assert torch.equal(done_a.wt, done_b.wt)
    assert int(state["sk"].apply_permutation(p).decrypt(done_b)) == int(
        sk.apply_permutation(p).decrypt(done_a))
    with pytest.raises(ValueError, match="may not contain"):
        tio.save_state(tmp_path / "bad.npz", {"a/b": sk})
    with pytest.raises(TypeError, match="cannot checkpoint"):
        tio.save_state(tmp_path / "bad.npz", {"x": 3})


def test_files_cross_between_packages(tmp_path):
    (jsk, jct), (tsk, tct), w = _pair(1247, 16, 33, 4, forced=(0, 5, 9))
    perm = np.random.default_rng(5).permutation(1247).astype(np.int32)
    jp, tp = J.Permutation(perm), T.Permutation(perm)
    # JAX -> port.
    jio.save_ciphertext(tmp_path / "j_ct.npz", jct)
    jio.save_secret_key(tmp_path / "j_sk.npz", jsk)
    jio.save_permutation(tmp_path / "j_p.npz", jp)
    jio.save_state(tmp_path / "j_state.npz", {"ct": jct, "sk": jsk, "p": jp})
    got = tio.load_ciphertext(tmp_path / "j_ct.npz", device="cpu")
    assert np.array_equal(words_to_numpy(got.wt), w)
    assert np.array_equal(tio.load_secret_key(tmp_path / "j_sk.npz", device="cpu").indices,
                          jsk.indices)
    assert tio.load_permutation(tmp_path / "j_p.npz") == tp
    state = tio.load_state(tmp_path / "j_state.npz", device="cpu")
    assert np.array_equal(words_to_numpy(state["ct"].wt), w) and state["p"] == tp
    assert int(state["sk"].decrypt(state["ct"])) == int(jsk.decrypt(jct)) == 1
    # Port -> JAX.
    tio.save_ciphertext(tmp_path / "t_ct.npz", tct)
    tio.save_secret_key(tmp_path / "t_sk.npz", tsk)
    tio.save_permutation(tmp_path / "t_p.npz", tp)
    tio.save_state(tmp_path / "t_state.npz", {"ct": tct, "sk": tsk, "p": tp})
    assert np.array_equal(np.asarray(jio.load_ciphertext(tmp_path / "t_ct.npz").wt), w)
    assert np.array_equal(jio.load_secret_key(tmp_path / "t_sk.npz").indices, tsk.indices)
    assert jio.load_permutation(tmp_path / "t_p.npz") == jp
    jstate = jio.load_state(tmp_path / "t_state.npz")
    assert np.array_equal(np.asarray(jstate["ct"].wt), w) and jstate["p"] == jp
    assert int(jstate["sk"].decrypt(jstate["ct"])) == 1


def test_sharded_dirs_cross_between_packages(tmp_path):
    (jsk, jct), (tsk, tct), w = _pair(95, 4, 67, 6, forced=(5, 66))
    tio.save_state_sharded(tmp_path / "t", {"acc": tct, "sk": tsk})
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert manifest["entries"]["acc"]["blocks"] == [[0, 67, "acc.c0.npy"]]
    back = tio.load_state_sharded(tmp_path / "t", device="cpu")
    assert np.array_equal(words_to_numpy(back["acc"].wt), w)
    jback = jio.load_state_sharded(tmp_path / "t")
    assert np.array_equal(np.asarray(jback["acc"].wt), w)
    want = int(jsk.decrypt(jct))     # random chunks match by chance at d = 4
    assert int(jback["sk"].decrypt(jback["acc"])) == want == int(back["sk"].decrypt(back["acc"]))
    jio.save_state_sharded(tmp_path / "j", {"acc": jct, "sk": jsk})
    got = tio.load_state_sharded(tmp_path / "j", device="cpu")
    assert np.array_equal(words_to_numpy(got["acc"].wt), w)
    assert np.array_equal(got["sk"].indices, jsk.indices)


def test_jax_eight_block_checkpoint_loads(tmp_path, ctx):
    """tests/test_io.py:75-106's checkpoint: a payload sharded over 8
    devices, one block per shard, loads whole and decrypts to 1."""
    from csgn_tpu.parallel import chunk_mesh, shard_ciphertext

    jsk = J.SecretKey.generate(ctx, jax.random.split(jax.random.key(0), 3)[0])
    words = _words(ctx, 64, 0)
    words[:, [3, 17, 40]] |= jsk.mask[:, None]
    ct = shard_ciphertext(J.Ciphertext(jnp.asarray(words), ctx), chunk_mesh(8))
    jio.save_state_sharded(tmp_path / "ck", {"acc": ct, "sk": jsk})
    assert len(list((tmp_path / "ck").glob("acc.c*.npy"))) == 8
    state = tio.load_state_sharded(tmp_path / "ck", device="cpu")
    assert np.array_equal(words_to_numpy(state["acc"].wt), words)
    assert int(state["sk"].decrypt(state["acc"])) == 1


def test_uneven_block_tables(tmp_path):
    """Blocks of uneven sizes assemble bit-equal in both packages, and in the
    port also when listed out of order; a table with a gap is refused, and
    nothing is zero-padded."""
    (_, _), (tsk, tct), w = _pair(1247, 16, 67, 8, forced=(5, 66))
    d = tmp_path / "uneven"
    tio.save_state_sharded(d, {"acc": tct, "sk": tsk})
    (d / "acc.c0.npy").unlink()
    blocks = [[0, 11, "acc.c0.npy"], [11, 29, "acc.c11.npy"], [40, 27, "acc.c40.npy"]]
    for start, cnt, f in blocks:
        np.save(d / f, np.ascontiguousarray(w[:, start:start + cnt].T))
    manifest = json.loads((d / "manifest.json").read_text())

    def load(table):
        manifest["entries"]["acc"]["blocks"] = table
        (d / "manifest.json").write_text(json.dumps(manifest))
        return tio.load_state_sharded(d, device="cpu")

    state = load(blocks)
    assert np.array_equal(words_to_numpy(state["acc"].wt), w)
    assert int(state["sk"].decrypt(state["acc"])) == 0
    assert np.array_equal(np.asarray(jio.load_state_sharded(d)["acc"].wt), w)
    state = load(blocks[::-1])
    assert np.array_equal(words_to_numpy(state["acc"].wt), w)
    manifest["entries"]["acc"]["blocks"] = [blocks[0], blocks[2]]
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="do not cover"):
        tio.load_state_sharded(d, device="cpu")


def test_version_errors(tmp_path):
    (_, _), (sk, ct), _ = _pair(95, 4, 3, 9)
    np.savez(tmp_path / "v2.npz", kind=np.array("ciphertext"),
             meta=np.array([2, 95, 4], np.int64), words=ct.chunk_major())
    with pytest.raises(ValueError, match="unsupported csgn checkpoint version 2"):
        tio.load_ciphertext(tmp_path / "v2.npz", device="cpu")
    np.savez(tmp_path / "p2.npz", kind=np.array("permutation"),
             meta=np.array([2, 95], np.int64), perm=np.arange(95))
    with pytest.raises(ValueError, match="unsupported csgn permutation version 2"):
        tio.load_permutation(tmp_path / "p2.npz")
    np.savez(tmp_path / "pn.npz", kind=np.array("permutation"),
             meta=np.array([1, 94], np.int64), perm=np.arange(95))
    with pytest.raises(ValueError, match="recorded n 94"):
        tio.load_permutation(tmp_path / "pn.npz")
    tio.save_state_sharded(tmp_path / "s", {"ct": ct})
    (tmp_path / "s" / "manifest.json").write_text(json.dumps({"version": 2, "entries": {}}))
    with pytest.raises(ValueError, match="unsupported csgn checkpoint version 2"):
        tio.load_state_sharded(tmp_path / "s", device="cpu")


def test_loads_default_to_the_card(tmp_path):
    """Without a device, a load lands on the current CUDA device, or raises
    naming device="cpu" where there is none."""
    (_, _), (sk, ct), w = _pair(95, 4, 3, 10)
    tio.save_state(tmp_path / "s.npz", {"ct": ct, "sk": sk})
    if torch.cuda.is_available():
        state = tio.load_state(tmp_path / "s.npz")
        assert state["ct"].wt.is_cuda and state["sk"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tio.load_state(tmp_path / "s.npz")
