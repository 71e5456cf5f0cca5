"""Host time of the re-key path an op, in µs: the program's spans (its
recorder, `csgn_tpu_torch.utils.metrics`, on in a traced run of the `rekey`
op) of `SecretKey.permute_and_decrypt` less their ``key.readback`` (the
wait for the device and the copy of the bit), plus ``key.apply_permutation``
(the rotated key's build and copies, before the op's span), over the
``key.permute_and_decrypt`` spans of the window.  None where the program
has no ``key.apply_permutation`` span."""


def read(run):
    from csgn_tpu_torch.utils.metrics import op_metrics

    spans = op_metrics().spans()
    ops = {i for i, s in enumerate(spans) if s.name == "key.permute_and_decrypt"}
    keys = [s for s in spans if s.name == "key.apply_permutation" and s.parent not in ops]
    if not ops or not keys:
        return None
    waits = sum(s.seconds for s in spans if s.name == "key.readback" and s.parent in ops)
    host = sum(spans[i].seconds for i in ops) - waits + sum(s.seconds for s in keys)
    return 1e6 * host / len(ops)
