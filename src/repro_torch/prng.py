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
  * ``categorical`` is the first-index argmax of ``gumbel + logits``;
  * ``normal`` is ``sqrt(2) * erf_inv(u)`` with ``u`` uniform in
    ``[nextafter(-1, 0), 1)``, and ``erf_inv`` is XLA's float32 lowering
    on the CPU, operation for operation (`_erf_inv_xla`);
  * ``randint`` draws two 32-bit words a value from the two halves of a
    split key and folds them into the span with unsigned 32-bit
    remainders.

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

from repro_torch.device import cpu_log_ready, fma32

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


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


# XLA's CPU log (Cephes' float32 polynomial) and log1p (Cephes' rational
# form below sqrt(2) - 1), the constants as XLA rounds them to float32
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Giles' erf_inv: coefficients for w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _f32c(v: float) -> float:
    """``v`` rounded to float32 (as a Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


def _log_xla(z: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU for positive normal ``z``: z = m 2^e
    with m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in m - 1, and
    e ln 2 added in two parts.  Where LLVM fuses a multiply into the add
    that consumes it (the multiply's only use), `device.fma32` rounds
    once."""
    zz = torch.clamp(z, min=2.0 ** -126)
    bits = zz.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = (bits & 0x7FFFFF | 0x3F000000).view(torch.float32)   # [0.5, 1)
    lt = m < _f32c(0.707106781186547524)
    x = (m - 1.0) + torch.where(lt, m, _f32(0.0, m))
    e = e - lt.float()
    x2 = x * x
    x3 = x2 * x
    p = [_f32c(c) for c in _LOG_P]
    y = fma32(fma32(x, p[0], p[1]), x, p[2])
    y1 = fma32(fma32(x, p[3], p[4]), x, p[5])
    y2 = fma32(fma32(x, p[6], p[7]), x, p[8])
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, e * _f32c(_LOG_Q1))
    x = fma32(-x2, 0.5, x) + y
    return fma32(e, _f32c(_LOG_Q2), x)


def _log1p_xla(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, for y in (-1, 0]: ``log(1 + y)``
    where |y| >= sqrt(2) - 1, else y - y^2 / 2 + y^3 P(y) / Q(y)."""
    den = torch.ones_like(y)
    for c in _LOG1P_DEN:
        den = fma32(den, y, _f32c(c))
    num = torch.full_like(y, _f32c(_LOG1P_NUM[0]))
    for c in _LOG1P_NUM[1:]:
        num = fma32(num, y, _f32c(c))
    y2 = y * y
    small = y + fma32(y2, -0.5, (y * y2) * (num / den))
    return torch.where(y.abs() < _f32c(0.41421356237309504880), small,
                       _log_xla(y + 1.0))


def _erf_inv_xla(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv`` for x in (-1, 1] as XLA lowers it on the CPU
    (Giles' approximation: w = -log1p(-x^2), a degree-8 polynomial in
    w - 2.5 or sqrt(w) - 3, times x; +-inf at +-1).  The square root is
    taken in float64 and rounded, which is float32's correctly rounded
    one (PyTorch's vectorised float32 CPU sqrt is not always)."""
    w = -_log1p_xla(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT[0], x), _f32(_ERFINV_GE[0], x))
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = fma32(p, w, torch.where(lt, _f32(a, x), _f32(b, x)))
    return torch.where(x.abs() == 1, torch.inf, p) * x


def normal(key: torch.Tensor, shape: tuple,
           dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, ``u``
    uniform in ``[nextafter(-1, 0), 1)``.  Bit-equal to the reference on
    the CPU: ``u`` takes 2**23 values, and every one of them gives the
    reference's bits (`tests/test_torch_vision_train.py`)."""
    if dtype != torch.float32:
        raise ValueError(f"normal supports float32, got {dtype}")
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(key, shape, torch.float32, lo, 1.0)
    return _erf_inv_xla(u) * _f32c(math.sqrt(2))


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` to int32 for integer ``minval`` /
    ``maxval``: both clipped to the int32 range; ``span = maxval - minval``
    as an unsigned 32-bit word (1 where maxval <= minval, one more where
    maxval lay above the int32 range); 32 high and 32 low random bits from
    the two halves of ``split(key)``; ``(hi % span) * mult + lo % span``
    with ``mult = (2**16 % span)**2 % span``, reduced mod span, all in
    wrapping unsigned 32-bit arithmetic, added to minval.  ``key`` is one
    key [2]; returns int32 ``shape``."""
    minval, maxval = int(minval), int(maxval)
    out_of_range = maxval > _I32_MAX
    lo_v = min(max(minval, _I32_MIN), _I32_MAX)
    hi_v = min(max(maxval, _I32_MIN), _I32_MAX)
    span = (hi_v - lo_v) & MASK32
    if hi_v <= lo_v:
        span = 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & MASK32
    k = split(key)
    higher = random_bits(k[0], 32, shape)
    lower = random_bits(k[1], 32, shape)
    if span == 0:           # the whole 2**32 range: XLA's x % 0 is x
        offset = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & MASK32) % span   # wraps, as XLA's
        a = higher % span           # a * mult mod 2**32, in 16-bit halves
        prod = a * (mult & 0xFFFF) + (((a * (mult >> 16)) & 0xFFFF) << 16)
        offset = (prod & MASK32) + lower % span
        offset = (offset & MASK32) % span
    val = (lo_v + offset) & MASK32
    return torch.where(val > _I32_MAX, val - 2 ** 32, val).to(torch.int32)


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
           "uniform", "gumbel", "categorical", "permutation", "argmax_first",
           "normal", "randint"]
