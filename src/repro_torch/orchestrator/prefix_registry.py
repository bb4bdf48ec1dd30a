"""PrefixRadix: a radix tree over page-aligned token blocks, plus the
host-RAM spill tier behind it.

This is the container-registry model applied to KV pages, one level down
from the flat prefix index it replaces. A container image is a stack of
content-addressed layers; N images sharing a base store its layers once,
and a registry pull re-materializes an evicted layer by digest. Here:

  * one radix NODE = one page-size token block, keyed by a CHAINED digest
    (``md5(parent_digest + block_bytes)``) -- the same scheme image
    manifests use, so a node's digest commits to its whole ancestry and
    two different paths can never alias;
  * a request's declared prefix walks the tree root-down
    (``PrefixRadix.match``): every fully-matched node is a shared layer,
    and when the declared prefix ends MID-block the walk finishes with a
    partial in-node match -- the first ``partial_len`` tokens of some
    registered child. KV at those positions depends only on the (identical)
    preceding tokens, so the boundary page can be merged read-only into the
    new request's first private page (the front-partial COW merge);
  * eviction under pool pressure prefers SPILL over discard: the page's
    contents move to the host-RAM ``SpillStore`` keyed by node digest, the
    device page returns to the free-list, and the node stays in the tree
    with ``page=None``. A later match "pulls" the layer back by digest
    (``PagePool`` restore) instead of re-prefilling it.

Tree invariants (``PagePool.check`` enforces them after every op in the
property tests):

  * a resident node's parent is resident (the resident subtree is rooted),
    so a chain restore is always parents-first and a spilled interior node
    never strands live descendants on device;
  * sum of child refcounts <= parent refcount (every sharer maps its whole
    root chain, sharers of different children are disjoint);
  * spilled nodes hold no device page and exactly mirror the spill store
    (conservation across tiers).

The tree itself is pure host bookkeeping -- it never touches a device
buffer. ``PagePool`` owns the page/refcount accounting and the actual
spill/restore data movement; ``SlotEngine`` registers the device-side
save/load callbacks.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np


def chained_digest(parent_digest: str, block: np.ndarray) -> str:
    """Content address of one page block GIVEN its ancestry: the parent's
    digest is folded into the hash, so equal blocks under different
    prefixes get different digests (exactly how image-layer chain ids
    work). Root ancestry is the empty string."""
    block = np.ascontiguousarray(np.asarray(block, np.int32))
    return hashlib.md5(parent_digest.encode() + block.tobytes()).hexdigest()


def block_digests(tokens: np.ndarray, page_size: int) -> list[str]:
    """Chained digests of every COMPLETE page block of ``tokens`` (the
    trailing partial block has no digest -- partial matches compare tokens
    directly). Shared by the pool (tree keys), the engine (promotion) and
    the router (family-anchor keys), so all three tiers address the same
    layer the same way."""
    tokens = np.asarray(tokens, np.int32)
    out: list[str] = []
    parent = ""
    for i in range(len(tokens) // page_size):
        parent = chained_digest(parent, tokens[i * page_size:
                                               (i + 1) * page_size])
        out.append(parent)
    return out


@dataclass
class RadixNode:
    """One page-aligned block in the prefix tree. ``page`` is the physical
    device page when resident, ``None`` while spilled to the host tier.
    Refcounts live in the pool's per-page array (single source of truth);
    a spilled node by construction has no sharers."""
    digest: str
    tokens: np.ndarray                  # (page_size,) int32 block
    parent: "RadixNode | None"
    depth: int                          # blocks from root (root = 0)
    children: dict[str, "RadixNode"] = field(default_factory=dict)
    page: int | None = None
    last_used: int = 0
    hits: int = 0

    @property
    def resident(self) -> bool:
        return self.page is not None

    def chain(self) -> list["RadixNode"]:
        """Root-first path from the tree root to this node (exclusive of
        the sentinel root)."""
        out: list[RadixNode] = []
        node = self
        while node.parent is not None:
            out.append(node)
            node = node.parent
        out.reverse()
        return out


@dataclass
class PrefixMatch:
    """Longest registered ancestry of a declared prefix: ``nodes`` are the
    fully-matched blocks root-first; ``partial`` is the boundary node whose
    first ``partial_len`` tokens extend the match mid-block (merge
    operand), or None when the boundary is page-aligned."""
    nodes: list[RadixNode]
    partial: RadixNode | None = None
    partial_len: int = 0

    @property
    def tokens_matched(self) -> int:
        ps = len(self.nodes[0].tokens) if self.nodes else (
            len(self.partial.tokens) if self.partial else 0)
        return len(self.nodes) * ps + self.partial_len

    def all_nodes(self) -> list[RadixNode]:
        """Chain plus the partial boundary node (everything that must be
        device-resident before the suffix prefill reads the pool)."""
        return self.nodes + ([self.partial] if self.partial else [])


class SpillStore:
    """Host-RAM tier of the page registry: evicted node payloads keyed by
    digest, LRU-ordered. ``capacity`` bounds resident payloads (None =
    unbounded); the POOL enforces it -- dropping a payload may require
    pruning a whole spilled subtree, which needs tree context this store
    does not have."""

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity < 0:
            raise ValueError("SpillStore capacity must be >= 0 or None")
        self.capacity = capacity
        self._data: OrderedDict[str, object] = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, digest: str) -> bool:
        return digest in self._data

    @property
    def over_capacity(self) -> int:
        """Payloads beyond capacity (0 when unbounded or within bounds)."""
        if self.capacity is None:
            return 0
        return max(0, len(self._data) - self.capacity)

    def put(self, digest: str, payload) -> None:
        if digest in self._data:
            raise RuntimeError(f"spill store already holds {digest!r}")
        self._data[digest] = payload

    def pop(self, digest: str):
        """Remove and return a payload (the restore path)."""
        return self._data.pop(digest)

    def discard(self, digest: str) -> None:
        self._data.pop(digest, None)

    def lru_digests(self) -> list[str]:
        """Digests oldest-first (insertion order = spill order; restores
        pop, so re-spills re-insert at the young end)."""
        return list(self._data.keys())

    def digests(self) -> set[str]:
        return set(self._data.keys())


class PrefixRadix:
    """The tree structure itself: match/insert/remove plus deterministic
    victim ordering. Pure host bookkeeping -- pages, refcounts and the
    spill data movement belong to ``PagePool``."""

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self.root = RadixNode(digest="", tokens=np.empty(0, np.int32),
                              parent=None, depth=0)
        self.node_count = 0

    # -- lookup -------------------------------------------------------------
    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest-prefix walk: consume whole page blocks while a child
        with the chained digest AND byte-identical tokens exists (a digest
        collision over different tokens stops the walk -- a miss at that
        depth, never a wrong share). Leftover tokens (< one page) try a
        PARTIAL in-node match against the children at the boundary;
        resident children win over spilled ones (no restore needed), ties
        break on digest so the choice is deterministic."""
        tokens = np.asarray(tokens, np.int32)
        ps = self.page_size
        nodes: list[RadixNode] = []
        cur = self.root
        k = 0
        while (k + 1) * ps <= len(tokens):
            block = tokens[k * ps:(k + 1) * ps]
            child = cur.children.get(chained_digest(cur.digest, block))
            if child is None or not np.array_equal(child.tokens, block):
                break
            nodes.append(child)
            cur = child
            k += 1
        rem = tokens[k * ps:]
        partial, plen = None, 0
        if len(rem) >= 1 and len(rem) < ps:
            for digest in sorted(cur.children,
                                 key=lambda d: (not cur.children[d].resident,
                                                d)):
                child = cur.children[digest]
                if np.array_equal(child.tokens[:len(rem)], rem):
                    partial, plen = child, len(rem)
                    break
        return PrefixMatch(nodes=nodes, partial=partial, partial_len=plen)

    # -- structure ----------------------------------------------------------
    def insert(self, parent: RadixNode, block: np.ndarray,
               page: int) -> RadixNode | None:
        """Register one complete block as a child of ``parent``. Returns
        None on a digest collision (an existing child under the digest
        with DIFFERENT tokens): first writer wins, the new block simply
        stays uncached -- the tree is never corrupted."""
        block = np.asarray(block, np.int32)
        if block.shape != (self.page_size,):
            raise ValueError(f"block must be exactly {self.page_size} "
                             f"tokens, got {block.shape}")
        digest = chained_digest(parent.digest, block)
        existing = parent.children.get(digest)
        if existing is not None:
            return None
        node = RadixNode(digest=digest, tokens=np.array(block, copy=True),
                         parent=parent, depth=parent.depth + 1, page=page)
        parent.children[digest] = node
        self.node_count += 1
        return node

    def remove(self, node: RadixNode) -> None:
        """Unlink a childless node (eviction discards leaf-first)."""
        if node.children:
            raise RuntimeError("removing a radix node with children")
        del node.parent.children[node.digest]
        node.parent = None
        self.node_count -= 1

    # -- iteration (deterministic order everywhere) -------------------------
    def walk(self) -> list[RadixNode]:
        """Every node, depth-first with children in digest order --
        deterministic for eviction scans and ``check``."""
        out: list[RadixNode] = []
        stack = [self.root.children[d]
                 for d in sorted(self.root.children, reverse=True)]
        while stack:
            node = stack.pop()
            out.append(node)
            stack.extend(node.children[d]
                         for d in sorted(node.children, reverse=True))
        return out

    def subtree(self, node: RadixNode) -> list[RadixNode]:
        """``node`` and every descendant, deepest-last."""
        out = [node]
        stack = [node.children[d]
                 for d in sorted(node.children, reverse=True)]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children[d] for d in sorted(n.children,
                                                       reverse=True))
        return out

    @property
    def max_depth(self) -> int:
        return max((n.depth for n in self.walk()), default=0)

    def check(self) -> None:
        """Structural invariants of the tree alone (the pool layers page
        and refcount conservation on top): parent links consistent, chained
        digests honest, depths correct, resident subtree rooted."""
        seen = 0
        for node in self.walk():
            seen += 1
            assert node.parent is not None, "walked node lost its parent"
            assert node.parent.children.get(node.digest) is node, \
                "parent/child link broken"
            assert node.depth == node.parent.depth + 1, "depth drift"
            assert node.digest == chained_digest(node.parent.digest,
                                                 node.tokens), \
                "stored digest does not match chained content"
            if node.resident:
                assert node.parent is self.root or node.parent.resident, \
                    f"resident node {node.digest[:8]} under spilled parent"
        assert seen == self.node_count, "node_count drift"
