"""The port's Fiat-Shamir ≡ the host duplex challenger (exact), on the CPU.

The device challenger's sponge state must equal the host
``DuplexChallenger``'s felt for felt after every observe / sample / grind,
the host challenger of the port must equal ``miden_tpu``'s, and every grind
must return the same (smallest) witness as ``miden_tpu``'s.
"""

import numpy as np
import pytest
import torch

from miden_tpu.transcript import challenger as JC
from miden_tpu_torch.field import gl
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.transcript import challenger as C
from miden_tpu_torch.transcript.device_challenger import DeviceChallenger, DeviceProverChannel


def _state(dev: DeviceChallenger) -> list:
    return [int(v) for v in F.to_numpy(dev.state)]


def _host_view(host) -> list:
    """The state the device challenger holds: pending input overwrites the
    rate lanes only at the next duplex, so compare the sponge state itself."""
    return list(host.state)


SCHEDULE = [(1, 1), (3, 2), (8, 1), (0, 3), (13, 5), (7, 0), (2, 9), (16, 0), (0, 1)]


def test_device_state_equals_host_after_every_call():
    rng = np.random.default_rng(7)
    host = C.DuplexChallenger([1, 2, 3, 4])
    jhost = JC.DuplexChallenger([1, 2, 3, 4])
    dev = DeviceChallenger.from_host(host.clone(), "cpu")
    for n_obs, n_smp in SCHEDULE:
        vals = [int(v) for v in rng.integers(0, gl.P, size=n_obs, dtype=np.uint64)]
        host.observe_slice(vals)
        jhost.observe_slice(vals)
        dev.observe_slice(vals)
        assert _state(dev) == _host_view(host) == jhost.state
        assert [int(v) for v in F.to_numpy(dev.ibuf)] == host.input_buffer
        for _ in range(n_smp):
            h = host.sample()
            assert h == jhost.sample()
            assert int(F.to_numpy(dev.sample().reshape(1))[0]) == h
            assert _state(dev) == host.state
    assert [int(v) for v in F.to_numpy(dev.finalize())] == host.finalize() == jhost.finalize()


def test_sample_ext_and_observe_tensor():
    host = C.DuplexChallenger([5, 6, 7, 8])
    dev = DeviceChallenger.from_host(host.clone(), "cpu")
    vals = F.to_torch(np.asarray([1, 2, 3, gl.P - 1, 1 << 63], dtype=np.uint64), "cpu")
    host.observe_slice([1, 2, 3, gl.P - 1, 1 << 63])
    dev.observe_arr(vals)
    assert [int(v) for v in F.to_numpy(dev.sample_ext())] == list(host.sample_ext())
    assert _state(dev) == host.state


def test_from_host_mid_stream():
    host = C.DuplexChallenger()
    host.observe_slice([5, 6, 7])
    dev = DeviceChallenger.from_host(host.clone(), "cpu")
    assert host.sample() == int(F.to_numpy(dev.sample().reshape(1))[0])
    host2 = C.DuplexChallenger()
    host2.observe_slice(list(range(8)))
    host2.sample()
    dev2 = DeviceChallenger.from_host(host2.clone(), "cpu")
    for _ in range(3):
        assert host2.sample() == int(F.to_numpy(dev2.sample().reshape(1))[0])


@pytest.mark.parametrize("bits,pending", [(1, 0), (4, 3), (8, 5), (12, 0)])
def test_grind_returns_the_smallest_witness(bits, pending):
    seed = [9, 9, 9, bits]
    host = C.DuplexChallenger(seed)
    jhost = JC.DuplexChallenger(seed)
    for h in (host, jhost):
        h.observe_slice(list(range(11, 11 + pending)))
    dev = DeviceChallenger.from_host(host.clone(), "cpu")
    want = jhost.grind(bits)
    assert host.grind(bits, device="cpu") == want
    witness, ok = dev.grind(bits)
    assert bool(ok) and int(witness) == want
    # no smaller witness passes
    for w in range(want):
        probe = JC.DuplexChallenger(seed)
        probe.observe_slice(list(range(11, 11 + pending)))
        assert not probe.check_witness(bits, w)
    assert _state(dev) == host.state == jhost.state
    assert host.sample() == int(F.to_numpy(dev.sample().reshape(1))[0])


def test_device_channel_transcript_matches_host_channel():
    seed = [4, 3, 2, 1]
    hch = C.ProverChannel(C.DuplexChallenger(seed))
    jch = JC.ProverChannel(JC.DuplexChallenger(seed))
    dch = DeviceProverChannel(DeviceChallenger.from_host(C.DuplexChallenger(seed), "cpu"))
    digest = (11, 22, 33, 44)
    for ch in (hch, jch):
        ch.send_field_slice([10, 20, 30])
        ch.send_commitment(digest)
        ch.send_ext_slice([(1, 2), (3, 4)])
    dch.send_field_slice([10, 20, 30])
    dch.send_commitment(F.to_torch(np.asarray(digest, dtype=np.uint64), "cpu"))
    dch.send_ext_slice(F.to_torch(np.asarray([[1, 2], [3, 4]], dtype=np.uint64), "cpu"))
    samples = [hch.sample() for _ in range(3)]
    assert samples == [jch.sample() for _ in range(3)]
    dev_samples = [dch.sample() for _ in range(3)]
    w = hch.grind(3, device="cpu")
    assert w == jch.grind(3)
    dch.grind(3)
    ext = hch.sample_ext()
    dev_ext = dch.sample_ext()
    for ch in (hch, jch):
        ch.hint_field_slice([7, 8])
        ch.hint_commitment((1, 2, 3, 4))
    dch.check("always true", torch.tensor(True))
    extra = dch.materialize(extra=torch.stack(dev_samples))
    dch.hint_field_slice([7, 8])
    dch.hint_commitment((1, 2, 3, 4))
    assert [int(v) for v in extra] == samples
    assert [int(v) for v in F.to_numpy(dev_ext)] == list(ext)
    d_dev, data_dev = dch.finalize()
    d_host, data_host = hch.finalize()
    d_jax, data_jax = jch.finalize()
    assert d_dev == d_host == d_jax
    assert data_dev.fields == data_host.fields == data_jax.fields
    assert data_dev.commitments == data_host.commitments == data_jax.commitments


def test_failed_device_check_raises_at_readback():
    dch = DeviceProverChannel(DeviceChallenger.from_host(C.DuplexChallenger(), "cpu"))
    dch.check("forced failure", torch.tensor(False))
    with pytest.raises(AssertionError, match="forced failure"):
        dch.materialize()


def test_verifier_channel_replays_and_checks_the_tail():
    pch = C.ProverChannel(C.DuplexChallenger([0, 0, 0, 0]))
    pch.send_field_slice([1, 2, 3])
    pch.grind(2, device="cpu")
    pch.hint_field_slice([4])
    digest, data = pch.finalize()
    vch = C.VerifierChannel(data, C.DuplexChallenger([0, 0, 0, 0]))
    assert vch.read_field_slice(3) == [1, 2, 3]
    vch.check_pow(2)
    assert vch.read_hint_fields(1) == [4]
    assert vch.finalize() == digest
    short = C.VerifierChannel(C.TranscriptData(data.fields[:-1], []), C.DuplexChallenger([0, 0, 0, 0]))
    short.read_field_slice(3)
    short.check_pow(2)
    with pytest.raises(C.TranscriptError):
        short.read_hint_fields(1)
