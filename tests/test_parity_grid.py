"""Sharded grid layout against the single-device fit on the XLA path:
segment-sum CSR and streamed chunked-COO shards, MU and Newton, host and
device loops, float64 and bf16 data (8 virtual CPU devices)."""
import jax
import pytest

from tests._parity import CASES, assert_match, pair

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

SHARDS = dict(n_shards=(2, 4), shard_layout="grid")


@pytest.mark.parametrize("solver,storage,loop", CASES)
def test_matches_single_device(solver, storage, loop):
    assert_match(*pair(SHARDS, solver, storage, loop))


@pytest.mark.parametrize("storage", ["csr", "chunked"])
def test_bf16_data_matches_single_device(storage):
    """bf16 shards: the same quantized X on both sides; the psum order
    and each iteration's bf16 rounding of the factor operand leave the
    fits close, not equal."""
    single, sharded = pair(SHARDS, "mu", storage, "host",
                           data_dtype="bfloat16", max_iter=4)
    assert_match(single, sharded, rtol=2e-2, atol=1e-4)
