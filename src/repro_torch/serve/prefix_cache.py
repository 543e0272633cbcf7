"""Radix cache of committed window-aligned prompt prefixes (host-only copy
of ``repro.serve.prefix_cache``; numpy only).

One trie node per prompt WINDOW, keyed by that window's raw token bytes:
a root-to-node path spells a window-aligned token prefix, and the node
holds (a) the id of the pool page storing that window's context rows and
(b) an opaque per-window payload the backend snapshotted when the window
was first computed (for the paged-attention backend: the window's summary
and routing rows, which are byte-identical for every request sharing the
prefix — the fast-weight view of the paper makes prefix reuse exactly
this cheap).  The cache is generic: it never interprets payloads and
talks to the backend only through the engine.

Reference counting: every node retains ONE reference on its page via the
engine's `_PageAllocator`, held until the node is evicted.  Slots that
attach a matched prefix retain their own references, so cache eviction
and slot retirement are order-independent — the page frees when the last
holder lets go.

Path integrity invariant: a node's payload may only reference pages on
its own root-anchored path.  Two rules enforce it structurally:

  * `insert` extends the trie only while the inserting slot's pages
    PHYSICALLY match the existing path (first divergence stops the walk),
    so a deep node never mixes one request's pages with another's;
  * eviction removes LEAVES only (LRU by a monotonic clock, the whole
    matched path is touched on every hit), so an ancestor a descendant's
    payload depends on can never disappear first.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np


class _Node:
    __slots__ = ("key", "page", "payload", "children", "parent", "last_used")

    def __init__(self, key: bytes, page: int, payload: Any,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.payload = payload
        self.children: dict[bytes, "_Node"] = {}
        self.parent = parent
        self.last_used = 0


class RadixPrefixCache:
    """Token-content-addressed trie over the shared page pool."""

    def __init__(self, alloc: Any, window: int):
        self.alloc = alloc
        self.w = window
        self.root = _Node(b"", -1, None, None)   # sentinel, owns no page
        self._clock = 0
        self.evictions = 0

    @property
    def n_nodes(self) -> int:
        count, stack = 0, list(self.root.children.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count

    @property
    def n_pages(self) -> int:
        """Pages currently pinned by the cache (== nodes: one page each)."""
        return self.n_nodes

    def _key(self, toks: np.ndarray, i: int) -> bytes:
        return np.ascontiguousarray(
            toks[i * self.w:(i + 1) * self.w], dtype=np.int32).tobytes()

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, toks: np.ndarray, max_windows: int) -> list[_Node]:
        """Longest cached prefix of ``toks``, as the node path (at most
        ``max_windows`` deep).  Touches the whole matched path so no node
        a caller may attach is the next eviction candidate."""
        path: list[_Node] = []
        node = self.root
        for i in range(max_windows):
            child = node.children.get(self._key(toks, i))
            if child is None:
                break
            self._touch(child)
            path.append(child)
            node = child
        return path

    def insert(self, toks: np.ndarray, n_windows: int, pages: list[int],
               payload_fn: Any) -> int:
        """Commit ``n_windows`` leading windows of ``toks``, stored in
        ``pages``, to the trie.  ``payload_fn()`` must return one payload
        per window and is called at most once — only when the walk
        actually creates nodes.  Returns the number of nodes added."""
        node = self.root
        payloads = None
        added = 0
        for i in range(n_windows):
            key = self._key(toks, i)
            child = node.children.get(key)
            if child is not None:
                if child.page != pages[i]:
                    # same tokens, different physical page: a concurrent
                    # duplicate prefill — keep the incumbent path, and do
                    # NOT extend below it with this slot's pages
                    break
                self._touch(child)
                node = child
                continue
            if payloads is None:
                payloads = payload_fn()
            self.alloc.retain([pages[i]])
            child = _Node(key, pages[i], payloads[i], node)
            self._touch(child)
            node.children[key] = child
            node = child
            added += 1
        return added

    def evict_one(self) -> bool:
        """Drop the least-recently-used LEAF, releasing its page
        reference.  Returns False when the cache is empty."""
        leaf: Optional[_Node] = None
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif leaf is None or node.last_used < leaf.last_used:
                leaf = node
        if leaf is None:
            return False
        del leaf.parent.children[leaf.key]
        leaf.parent = None
        self.alloc.release([leaf.page])
        self.evictions += 1
        return True
