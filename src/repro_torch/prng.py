"""Threefry-2x32 random numbers (port of the parts of ``jax.random`` that the
serving path calls), on tensors with an explicit device.

The reference runs JAX with ``jax_threefry_partitionable`` on, so these are
the partitionable forms:

  * a key is a pair of 32-bit words, here an int64 tensor ``[..., 2]``
    holding values in ``[0, 2**32)``; ``PRNGKey(seed)`` is ``[0, seed]``;
  * ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under the key;
  * ``split(key, num)`` hashes the counter pairs of ``0 .. num - 1``, and
    ``permutation`` sorts by fresh ``random_bits`` once a round;
  * ``random_bits`` hashes, for each element, the pair (high word, low
    word) of its flat index within ``shape`` and returns ``bits1 ^ bits2``,
    truncated to the requested width;
  * ``uniform`` puts the top mantissa bits under the exponent of 1.0 and
    subtracts 1 (bfloat16 draws 8 bits, as JAX does for dtypes with fewer
    than 8 mantissa bits), then scales to ``[minval, maxval)`` (one fused
    multiply-add in float32, as XLA compiles it on the CPU) and clamps at
    ``minval``;
  * ``gumbel`` (mode "low") is ``-log(-log(uniform(tiny, 1)))``;
  * ``categorical`` is the first-index argmax of ``gumbel + logits``.

Words are carried in int64 and masked to 32 bits after every add and
shift, since unsigned 32-bit arithmetic is missing from some PyTorch
builds; right shifts of the non-negative words are logical.  A batch of
keys ``[*B, 2]`` with a sample ``shape`` gives ``[*B, *shape]``, with the
counters running over ``shape`` alone: each key's draw equals the
reference's ``jax.vmap`` over keys.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import cpu_log_ready

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# (bits of the float, mantissa bits, bits drawn) per float dtype
_FLOAT_BITS = {torch.float32: (32, 23, 32), torch.bfloat16: (16, 7, 8),
               torch.float16: (16, 10, 16)}
_INT_VIEW = {32: torch.int32, 16: torch.int16}


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """The key of a 32-bit integer seed: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash, 20 rounds, with the key schedule of
    ``jax._src.prng``: words (``x0``, ``x1``) under key (``k1``, ``k2``),
    all int64 tensors broadcast together.  Returns the two output words."""
    shape = torch.broadcast_shapes(k1.shape, k2.shape, x0.shape, x1.shape)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x0 + ks[0]).bitwise_and_(MASK32).expand(shape).contiguous()
    b = (x1 + ks[1]).bitwise_and_(MASK32).expand(shape).contiguous()
    for j in range(1, 6):
        for r in _ROTATIONS[(j - 1) % 2]:
            a.add_(b).bitwise_and_(MASK32)
            b = torch.bitwise_left_shift(b, r).bitwise_and_(MASK32) \
                .bitwise_or_(b >> (32 - r)).bitwise_xor_(a)
        a.add_(ks[j % 3]).bitwise_and_(MASK32)
        b.add_(ks[(j + 1) % 3] + j).bitwise_and_(MASK32)
    return a, b


def _words(key: torch.Tensor, n_sample_dims: int):
    """The key's two words, shaped to broadcast over ``n_sample_dims``
    trailing sample dimensions."""
    lead = key.shape[:-1] + (1,) * n_sample_dims
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` [..., 2] and 32-bit
    ``data`` (an int or an integer tensor broadcast against the keys'
    leading dimensions).  Returns keys [..., 2]."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) \
        .bitwise_and(MASK32)
    k1, k2 = key[..., 0], key[..., 1]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): key ``i`` of ``num`` is
    the hash of the counter pair (high word, low word) of ``i`` under
    ``key`` [2].  Returns keys [num, 2]."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int,
                shape: tuple) -> torch.Tensor:
    """Uniform random words of ``bit_width`` (8, 16 or 32) bits, int64
    values, shape ``key.shape[:-1] + shape``."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & MASK32)
    bits = b1.bitwise_xor_(b2)
    return bits if bit_width == 32 else bits.bitwise_and_(
        (1 << bit_width) - 1)


def uniform(key: torch.Tensor, shape: tuple, dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: floats in ``[minval, maxval)``."""
    if dtype not in _FLOAT_BITS:
        raise ValueError(f"uniform supports {list(_FLOAT_BITS)}, got {dtype}")
    nbits, nmant, rng_bits = _FLOAT_BITS[dtype]
    bits = random_bits(key, rng_bits, shape)
    one = torch.tensor(1.0, dtype=dtype).view(_INT_VIEW[nbits]).item()
    fbits = (bits >> (rng_bits - nmant)).bitwise_or_(one)
    floats = fbits.to(_INT_VIEW[nbits]).view(dtype) - 1.0
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    if dtype == torch.float32:
        # XLA contracts the float32 multiply-add into one FMA; float64
        # holds the product exactly, so the sum is rounded once
        scaled = (floats.double() * (hi - lo).double()
                  + lo.double()).float()
    else:
        scaled = floats * (hi - lo) + lo
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, shape: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in mode "low": ``-log(-log(u))`` with ``u``
    uniform in ``[tiny, 1)``."""
    u = uniform(key, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    if u.device.type == "cpu":
        cpu_log_ready()
    return -torch.log(-torch.log(u))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)`` by
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds (one round for n up to ~1625),
    each of which splits the key, draws 32-bit sort keys for the n
    elements with the subkey and sorts by them (``lax.sort_key_val``,
    stable: equal sort keys keep their order).  Returns int64 [n]."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, 32, (n,)), stable=True).indices
        x = x[order]
    return x


def argmax_first(x: torch.Tensor) -> torch.Tensor:
    """First index of the maximum over the last axis, as int32, with NaN
    read as +inf (the first NaN wins, as in ``np.argmax``)."""
    v = x.shape[-1]
    x = torch.where(torch.isnan(x), torch.inf, x)
    mx = x.amax(dim=-1, keepdim=True)
    ids = torch.arange(v, dtype=torch.int32, device=x.device)
    return torch.where(x == mx, ids, v).amin(dim=-1).to(torch.int32)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: one draw per row
    of ``logits`` [..., V], from ONE key (the counters run over the whole
    of ``logits.shape``).  Returns int32 [...]."""
    return argmax_first(gumbel(key, tuple(logits.shape), logits.dtype)
                        + logits)


__all__ = ["PRNGKey", "threefry2x32", "fold_in", "split", "random_bits",
           "uniform", "gumbel", "categorical", "permutation", "argmax_first"]
