"""The port's radix prefix cache (`repro_torch.serve.prefix_cache`) and
its engine lifecycle, after ``tests/test_prefix_cache.py``: the trie's
physical-match insert walk, leaf-only LRU eviction and ref counting, and
in the engine, cache pages reclaimed before live work, no cache traffic
for non-aligned prompts, and a cancelled hit releasing only its own
references.  Engine runs use the smoke qwen3-0.6b config (window 16) with
the JAX init's weights; tokens are held to a cache-off run.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import transformer as jtfm
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.convert import params_from_jax
from repro_torch.serve import EngineConfig, Request, ServingEngine
from repro_torch.serve.engine import _PageAllocator
from repro_torch.serve.prefix_cache import RadixPrefixCache

W = 8          # trie tests
SW = 16        # the smoke config's window


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -------------------------------------------------------------------- trie --

def test_radix_trie_insert_match_refcounts():
    al = _PageAllocator(16)
    cache = RadixPrefixCache(al, W)
    toks = np.arange(4 * W, dtype=np.int32)
    pages = al.alloc(4)
    payloads = [f"w{i}" for i in range(4)]
    assert cache.insert(toks, 4, pages, lambda: payloads) == 4
    assert cache.n_pages == 4
    assert all(al.refcount(p) == 2 for p in pages)   # holder + trie
    nodes = cache.match(toks, 4)
    assert [nd.page for nd in nodes] == pages
    assert [nd.payload for nd in nodes] == payloads
    assert [nd.page for nd in cache.match(toks, 2)] == pages[:2]
    other = toks.copy()
    other[W] += 1                                    # diverge in window 1
    assert [nd.page for nd in cache.match(other, 4)] == pages[:1]
    al.release(pages)                    # trie-held pages stay alive
    assert al.in_use == 4 and not set(pages) & set(al.free)


def test_radix_trie_physical_divergence_stops_insert():
    """A duplicate prefill (same tokens, other pages) adds nothing and
    snapshots nothing; extending the incumbent path is fine."""
    al = _PageAllocator(16)
    cache = RadixPrefixCache(al, W)
    toks = np.arange(3 * W, dtype=np.int32)
    first = al.alloc(3)
    cache.insert(toks, 3, first, lambda: list("abc"))
    dup = al.alloc(3)
    calls = []
    assert cache.insert(toks, 3, dup,
                        lambda: calls.append(1) or list("xyz")) == 0
    assert not calls and all(al.refcount(p) == 1 for p in dup)
    ext = np.concatenate([toks, np.full(W, 90, np.int32)])
    tail = al.alloc(1)
    assert cache.insert(ext, 4, first + tail, lambda: list("abcd")) == 1
    assert [nd.page for nd in cache.match(ext, 4)] == first + tail


def test_radix_trie_evicts_lru_leaf_only():
    al = _PageAllocator(16)
    cache = RadixPrefixCache(al, W)
    toks = np.arange(3 * W, dtype=np.int32)
    pages = al.alloc(3)
    cache.insert(toks, 3, pages, lambda: list("abc"))
    al.release(pages)                    # the trie is the only holder
    assert cache.evict_one()
    assert pages[2] in al.free and pages[1] not in al.free
    assert [nd.page for nd in cache.match(toks, 3)] == pages[:2]
    assert cache.evict_one() and cache.evict_one()
    assert not cache.evict_one() and al.in_use == 0
    assert cache.evictions == 3


# ------------------------------------------------------------------ engine --

@pytest.fixture(scope="module")
def smoke():
    jc = jget_arch("qwen3-0.6b", smoke=True).model
    tc = tget_arch("qwen3-0.6b", smoke=True).model
    return tc, params_from_jax(jax.device_get(
        jtfm.lm_init(jax.random.PRNGKey(0), jc)))


def _trace(n_req, vocab, shared_w=4, tail_w=2, gen=6, seed=0):
    """Requests sharing a ``shared_w``-window prefix, unique tails."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared_w * SW).astype(np.int32)
    return [Request(rid=i, prompt=np.concatenate(
        [head, rng.integers(0, vocab, tail_w * SW).astype(np.int32)]),
        max_new_tokens=gen) for i in range(n_req)]


def _engine(smoke, cache, **kw):
    tc, tp = smoke
    base = dict(n_slots=3, pages_per_slot=8, n_pages=40,
                prefill_chunk=2 * SW, prefix_cache=cache)
    base.update(kw)
    return ServingEngine(tp, tc, EngineConfig(**base), device="cpu")


def test_cache_pages_reclaimed_under_pressure_before_preemption(smoke):
    """New admissions need the cache's pages: LRU leaves are evicted and
    no live request is preempted; tokens equal the cache-off run."""
    vocab = smoke[0].vocab
    trace = [_trace(1, vocab, shared_w=3, tail_w=1, gen=4, seed=s)[0]
             for s in range(4)]
    for i, r in enumerate(trace):
        r.rid = i
    kw = dict(n_slots=2, pages_per_slot=6, n_pages=13)
    ref = {f.rid: f.tokens for f in _engine(smoke, False, **kw).run(
        [Request(rid=r.rid, prompt=r.prompt.copy(), max_new_tokens=4)
         for r in trace])}
    warm = _engine(smoke, True, **kw)
    done = warm.run(trace)
    st = warm.stats()
    assert st["prefix_cache_evictions"] > 0
    assert st["preemptions"] == 0
    for f in done:
        np.testing.assert_array_equal(f.tokens, ref[f.rid])


def test_nonaligned_prompts_never_match_or_insert(smoke):
    """A chunk-servable prompt that is not window-aligned (4w + 4) trains
    its landmarks on another grid: no cache traffic, cold tokens."""
    prompt = np.random.default_rng(21).integers(
        0, smoke[0].vocab, 4 * SW + 4).astype(np.int32)
    warm, cold = _engine(smoke, True), _engine(smoke, False)
    for eng in (warm, cold):
        eng.run([Request(rid=i, prompt=prompt.copy(), max_new_tokens=4)
                 for i in range(2)])
    assert warm.cache.n_nodes == 0
    st = warm.stats()
    assert st["prefix_cache_hits"] == 0 and st["pages_shared"] == 0
    tok_c = {f.rid: f.tokens for f in cold.finished}
    for f in warm.finished:
        np.testing.assert_array_equal(f.tokens, tok_c[f.rid])


def test_cancel_hit_request_releases_only_its_refs(smoke):
    """Cancelling a cache-hit request mid-decode drops the slot's
    references and keeps the trie's: only singular trie refs remain."""
    vocab = smoke[0].vocab
    warm = _engine(smoke, True)
    warm.run(_trace(1, vocab, gen=2))
    trie_pages = warm.cache.n_pages
    r = _trace(2, vocab, gen=14)[1]
    warm.submit(r)
    for _ in range(8):
        warm.step()
    assert warm.prefix_hits.get(r.rid, 0) > 0
    assert warm.cancel(r.rid)
    assert warm.alloc.in_use == warm.cache.n_pages >= trie_pages
    assert all(c == 1 for c in warm.alloc.refs.values())
    assert not warm.step()
