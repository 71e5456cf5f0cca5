"""The port's run configuration, CLI and runtime checks against the JAX
package's (`csgn_tpu.config`, `csgn_tpu.cli`, `csgn_tpu.utils.checks`)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import csgn_tpu as J
from csgn_tpu import cli as jcli
from csgn_tpu.config import RunConfig as JRunConfig
from csgn_tpu.utils import checks as jchecks
from csgn_tpu_torch import Ciphertext, Context, RunConfig, SecretKey, cli
from csgn_tpu_torch.layout import words_from_numpy, words_to_numpy
from csgn_tpu_torch.utils import checks
from csgn_tpu_torch.utils.timing import Timer, device_median_time

SMALL = ["--n", "95", "--d", "4", "--device", "cpu"]


def test_runconfig_json_roundtrip():
    cfg = RunConfig(n=4095, d=32, seed=7, batch=64, mul_strategy="ring")
    back = RunConfig.from_json(cfg.to_json())
    assert back == cfg and back.context() == Context(4095, 32)


def test_runconfig_crosses_between_packages():
    cfg = RunConfig(n=95, d=4, seed=3, batch=512, mesh_devices=2, mul_strategy="ring")
    jcfg = JRunConfig.from_json(cfg.to_json())
    assert jcfg == JRunConfig(n=95, d=4, seed=3, batch=512, mesh_devices=2, mul_strategy="ring")
    assert RunConfig.from_json(jcfg.to_json()) == cfg
    assert RunConfig.from_json(JRunConfig().to_json()) == RunConfig()


def test_runconfig_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown config keys"):
        RunConfig.from_json('{"n": 10, "bogus": 1}')


def test_cli_demo_selftest_info(capsys, tmp_path):
    assert cli.main(["demo", *SMALL]) == 0
    out = capsys.readouterr().out
    assert "Dec ( Enc (1) + Enc (0) ) = 1" in out and "Dec ( Enc (1) * Enc (0) ) = 0" in out
    assert "Dec_perm ( Perm ( Enc (1) ) ) = 1" in out and "demo OK" in out
    assert cli.main(["selftest", *SMALL]) == 0
    assert "roundtrip x1024: OK" in capsys.readouterr().out
    path = tmp_path / "cfg.json"
    path.write_text(RunConfig(n=95, d=4, batch=300).to_json())
    assert cli.main(["selftest", "--config", str(path), "--device", "cpu"]) == 0
    assert "roundtrip x300: OK" in capsys.readouterr().out
    assert cli.main(["info", *SMALL, "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "n=95 d=4" in out and "device: cpu" in out and "cuda devices:" in out


def test_cli_timings_rows(capsys, tmp_path):
    """The reference's eight rows and size lines, and the write anchor."""
    path = tmp_path / "cfg.json"
    path.write_text(RunConfig(n=95, d=4, batch=256).to_json())
    assert cli.main(["timings", "--config", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for row in ("keygen:", "encrypt x256:", "add 256+256 chunks:", "multiply 256x256 chunks:",
                "write anchor 256x256 chunks:", "permutation generation:",
                "permute secret key:", "permute ciphertext (256 chunks):",
                "decrypt 256 chunks (permuted key):", "Secret key size: 48 bytes",
                "Fresh ciphertext size: 64 bytes",
                "After multiplication ciphertext size: 64 bytes",
                "After addition ciphertext size: 96 bytes", "dispatch.mul.plain"):
        assert row in out, row


def _record(monkeypatch) -> dict:
    """Every encrypt's (key indices, words) and every key transform's
    permutation, of both packages' SecretKey, in call order."""
    logs = {"port": [], "jax": []}
    for side, cls, to_np in (("port", SecretKey, words_to_numpy), ("jax", J.SecretKey, np.asarray)):
        def encrypt_batch(self, *args, _orig=cls.encrypt_batch, _log=logs[side], _np=to_np,
                          **kw):
            words = _orig(self, *args, **kw)
            _log.append(("encrypt", self.indices.tolist(), _np(words).tolist()))
            return words

        def apply_permutation(self, p, _orig=cls.apply_permutation, _log=logs[side]):
            _log.append(("permutation", np.asarray(p.perm).tolist()))
            return _orig(self, p)

        monkeypatch.setattr(cls, "encrypt_batch", encrypt_batch)
        monkeypatch.setattr(cls, "apply_permutation", apply_permutation)
    return logs


@pytest.mark.parametrize("command", ["demo", "selftest"])
def test_cli_keys_and_words_equal_the_jax_cli(monkeypatch, capsys, command):
    """The same seed gives the same secret keys, ciphertext words and
    permutations in both CLIs: the keys are split from rng.key(seed) as from
    jax.random.key(seed)."""
    logs = _record(monkeypatch)
    assert cli.main([command, *SMALL, "--seed", "5"]) == 0
    assert jcli.main([command, "--n", "95", "--d", "4", "--seed", "5"]) == 0
    capsys.readouterr()
    assert len(logs["port"]) == {"demo": 3, "selftest": 1}[command]
    assert logs["port"] == logs["jax"]


def test_cli_flagship_matches_the_jax_cli(monkeypatch, capsys):
    logs = _record(monkeypatch)
    assert cli.main(["flagship", *SMALL]) == 0
    out = capsys.readouterr().out
    assert jcli.main(["flagship", "--n", "95", "--d", "4"]) == 0
    jout = capsys.readouterr().out
    assert len(logs["port"]) == 3 and logs["port"] == logs["jax"]

    def hexes(text):
        return re.findall(r"homomorphically = ([0-9a-f]+)", text)

    assert hexes(out) == hexes(jout) and len(hexes(out)) == 2
    assert hexes(out)[0] == "69c4e0d86a7b0430d8cdb78070b4c55a"   # FIPS-197 C.1
    assert "flagship OK" in out


def test_cli_defaults_to_the_card(capsys):
    if torch.cuda.is_available():
        assert cli.main(["info", "--n", "95", "--d", "4"]) == 0
        assert "device: cuda" in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cli.main(["info", "--n", "95", "--d", "4"])


def _corrupted(ctx, jctx):
    """A fresh bit-1 ciphertext, and the same words with a padding bit set."""
    idx = np.arange(ctx.d, dtype=np.int32) * 5
    jsk, sk = J.SecretKey(jctx, idx), SecretKey(ctx, idx, device="cpu")
    words = np.asarray(jsk.encrypt_batch(jnp.asarray([1], jnp.uint8), 7, engine="counter"))
    bad = words.copy()
    bad[-1, 0] |= 1   # the last word is all padding at n = 1247
    return jsk, sk, words, bad


def test_checks_agree_with_jax(ctx):
    tctx = Context(ctx.n, ctx.d)
    jsk, sk, words, bad = _corrupted(tctx, ctx)
    checks.validate_key(sk)
    jchecks.validate_key(jsk)
    checks.validate_ciphertext(Ciphertext(words_from_numpy(words, "cpu"), tctx))
    jchecks.validate_ciphertext(J.Ciphertext(jnp.asarray(words), ctx))
    with pytest.raises(ValueError, match="non-canonical ciphertext: set bit beyond n=1247 "
                                         "in chunk 0, word 39"):
        checks.validate_ciphertext(Ciphertext(words_from_numpy(bad, "cpu"), tctx))
    with pytest.raises(ValueError, match="in chunk 0, word 39"):
        jchecks.validate_ciphertext(J.Ciphertext(jnp.asarray(bad), ctx))

    valid = words_from_numpy(tctx.valid_mask, "cpu")
    err, jparity = jchecks.checked_decrypt(jnp.asarray(words), jnp.asarray(jsk.mask),
                                           jnp.asarray(ctx.valid_mask))
    err.throw()
    assert checks.checked_decrypt(words_from_numpy(words, "cpu"), sk.mask_words, valid) \
        == int(jparity) == 1
    err, _ = jchecks.checked_decrypt(jnp.asarray(bad), jnp.asarray(jsk.mask),
                                     jnp.asarray(ctx.valid_mask))
    with pytest.raises(Exception, match="non-canonical"):
        err.throw()
    with pytest.raises(ValueError, match="non-canonical ciphertext: bits set beyond n"):
        checks.checked_decrypt(words_from_numpy(bad, "cpu"), sk.mask_words, valid)


def test_validate_key_rejects_inconsistent_mask():
    sk = SecretKey(Context(95, 4), [1, 5, 9, 70], device="cpu")
    object.__setattr__(sk, "_mask", sk.mask | np.array([0, 0, 1, 0], np.uint32))
    with pytest.raises(ValueError, match="mask popcount 5 != d 4"):
        checks.validate_key(sk)


def test_timer_and_device_median_time():
    t = Timer("x")
    with pytest.raises(RuntimeError, match="without start"):
        t.stop()
    t.start()
    assert t.stop() >= 0 and t.elapsed_ms >= 0
    calls = []
    s = device_median_time(lambda: calls.append(1), reps=5, device="cpu")
    assert len(calls) == 6 and 0 <= s < 1
