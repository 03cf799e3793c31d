"""The port's device-resident datasets (``data/device.py``) against the JAX
package's, on the CPU: the resident arrays in float32 and bfloat16 bit for
bit (both round float32 to bfloat16 to nearest even), the loaders' batches
in the same order for the same seed, and ``RotatingDeviceDataset``'s shard
schedule and contents.  No tolerance: everything here is exact.
"""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu import data as jdata
from learned_hologram_gan_tpu_torch import data
from test_torch_tools import one_torch_thread  # noqa: F401

N, C, H, W = 7, 3, 8, 12


@pytest.fixture(scope="module")
def bins(tmp_path_factory):
    d = tmp_path_factory.mktemp("bins")
    rng = np.random.default_rng(11)
    for name in ("img", "depth", "amp", "phs"):
        # values spread over many binades, halfway cases for bfloat16 included
        x = (rng.standard_normal((N, C, H, W)) * np.exp(rng.uniform(-20, 20, (N, C, H, W))))
        x.astype(np.float32).tofile(os.path.join(d, f"{name}.bin"))
    halfway = np.frombuffer(np.array([0x3F808000, 0x3F818000, 0xBF808000], np.uint32).tobytes(), np.float32)
    with open(os.path.join(d, "amp.bin"), "r+b") as f:
        f.write(halfway.tobytes())
    return str(d)


def _datasets(bins):
    paths = [os.path.join(bins, f"{n}.bin") for n in ("img", "depth", "amp", "phs")]
    kw = dict(samples_num=N, channels_num=C, height=H, width=W)
    return (data.ImgDepthAmpPhsDataset(*paths, **kw), jdata.ImgDepthAmpPhsDataset(*paths, **kw))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resident_arrays_equal_jax_bit_for_bit(bins, dtype):
    ds, jds = _datasets(bins)
    got = data.dataset_to_device(ds, dtype=getattr(torch, dtype) if dtype == "bfloat16" else None,
                                 device="cpu")
    want = jdata.dataset_to_device(jds, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), _jbits(w))
    if dtype == "bfloat16":  # the halfway cases round to the even neighbour
        np.testing.assert_array_equal(_bits(got[1]).flatten()[:3].view(np.uint16), [0x3F80, 0x3F82, 0xBF80])


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 2), (False, False, 3), (True, False, 3)])
def test_device_loader_order_matches_jax(bins, shuffle, drop_last, batch):
    ds, jds = _datasets(bins)
    got = list(data.device_epoch_loader(data.dataset_to_device(ds, device="cpu"), batch, shuffle=shuffle,
                                        drop_last=drop_last, seed=7))
    want = list(jdata.device_epoch_loader(jdata.dataset_to_device(jds), batch, shuffle=shuffle,
                                          drop_last=drop_last, seed=7))
    stream = list(data.epoch_loader(ds, batch, shuffle=shuffle, drop_last=drop_last, seed=7, device="cpu"))
    assert len(got) == len(want) == len(stream) > 0
    for g, w, s in zip(got, want, stream):
        for a, b, c in zip(g, w, s):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert torch.equal(a, c)


def test_rotating_dataset_schedule_and_shards_match_jax(bins):
    ds, jds = _datasets(bins)
    rot = data.RotatingDeviceDataset(ds, shards=3, dtype=torch.bfloat16, block_epochs=2, device="cpu")
    jrot = jdata.RotatingDeviceDataset(jds, shards=3, dtype=jnp.bfloat16, block_epochs=2)
    for epoch in range(8):
        assert rot.shard_for_epoch(epoch) == jrot.shard_for_epoch(epoch)
        got = list(rot.epoch_loader(2, epoch, seed=epoch))
        want = list(jrot.epoch_loader(2, epoch, seed=epoch))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(_bits(a), _jbits(b))
    resident = rot.arrays_for_epoch(7)
    assert rot.arrays_for_epoch(7) is resident  # no re-upload within a shard's block
    rot.evict()
    assert rot._resident is None
    with pytest.raises(ValueError):
        data.RotatingDeviceDataset(ds, shards=0, device="cpu")


@pytest.mark.parametrize("shuffle,drop_last,batch", [(True, True, 2), (False, False, 3)])
def test_streaming_loader_bfloat16_wire_matches_jax(bins, shuffle, drop_last, batch):
    """The streaming loader with a bfloat16 wire dtype (``quality_run
    --streaming --data_dtype bfloat16``): each batch cast on the host, bit
    for bit the JAX package's ``epoch_loader(..., dtype=jnp.bfloat16)``,
    halfway cases rounded to the even neighbour."""
    ds, jds = _datasets(bins)
    got = list(data.epoch_loader(ds, batch, shuffle=shuffle, drop_last=drop_last, seed=9, device="cpu",
                                 dtype=torch.bfloat16))
    want = list(jdata.epoch_loader(jds, batch, shuffle=shuffle, drop_last=drop_last, seed=9, dtype=jnp.bfloat16))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
            np.testing.assert_array_equal(_bits(a), _jbits(b))
    first = got[0][1] if not shuffle else None
    if first is not None:  # sample 0's amp leads with the halfway cases
        np.testing.assert_array_equal(_bits(first).flatten()[:3].view(np.uint16), [0x3F80, 0x3F82, 0xBF80])
