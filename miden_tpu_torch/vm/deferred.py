"""Deferred-precompile DAG: content-addressed nodes, registry, wire form.

Re-designs the reference's deferred-state core (core/src/deferred/
{node,state,wire,precompile,precompile_registry}.rs) for this framework.
The deferred state is a content-addressed DAG of *nodes*; programs log
precompile *statements* into a rolling **deferred root** which a main
proof binds and a precompile-VM session proof (precompile/session.py)
later discharges.

Canonical node digest (node.rs:487-501): a Poseidon2 sponge with the
4-felt tag word in the capacity and the payload absorbed rate-first,
one 8-felt chunk per permutation::

    state[8:12] = tag.as_word()
    for chunk in payload.chunks: state[0:8] = chunk; state = P(state)
    digest = state[0:4]

Framework tags (node.rs:50-56): TRUE = [0,0,0,0] (digest = 0 = the
empty deferred root), AND = [1,0,0,0], CHUNKS = [2,0,0,0]. The AND
digest ``P([lhs, rhs, 1, 0, 0, 0])[0:4]`` is exactly the LOGDEFERRED
fold constrained in the main VM AIR (vm/processor.py LOGDEFERRED), so
the DAG root and the in-circuit rolling root agree by construction.

Wire form (wire.rs): a canonical, topologically ordered, root-last
entry stream with u32 child references (index 0 = implicit TRUE).
Rehydration is strict: decoded state must re-encode to the identical
wire, and the implicit root must evaluate to TRUE under the installed
registry. Partial proofs carry wire; final proofs carry a session STARK
for the same root (vm/prove.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..field import gl
from ..hash import poseidon2_host as hp

P = gl.P

#: secp256k1 base-field prime (the EC claims' coordinate field)
EC_P = 2**256 - 2**32 - 977


def _inv(a: int, m: int) -> int:
    """a^(m−2) mod m (0 for a ≡ 0), by the extended Euclid of ``pow``."""
    return pow(a, -1, m) if a % m else 0


Digest = tuple  # 4 field elements
Chunk = tuple  # 8 field elements (one Poseidon2 rate block)

TRUE_DIGEST: Digest = (0, 0, 0, 0)

#: little-endian bytes carried by one chunk (8 packed-u32 felts)
PACKED_BYTES_PER_CHUNK = 32

# framework-reserved tag ids (node.rs:50-62)
TAG_TRUE_ID = 0
TAG_AND_ID = 1
TAG_CHUNKS_ID = 2

# precompile ids used by the in-tree precompiles. The reference derives
# ids by hashing the precompile name (precompile.rs:75-78); here the
# in-circuit chain AIR commits the id as a trace column, so small pinned
# constants keep the constraint degree low. `precompile_id` provides the
# name-derived form for external precompiles.
PID_U256_ADD = 3
PID_KECCAK_MERGE = 4
PID_U256_MUL = 5
PID_KECCAK256 = 6
PID_EC_ADD = 7
PID_EC_MUL = 8


class DeferredError(ValueError):
    """Invalid deferred node, tag, payload, or state transition."""


class IntegrityError(DeferredError):
    """Untrusted wire data failed strict canonical rehydration."""


def precompile_id(name: str) -> int:
    """Stable name-derived precompile id (precompile.rs:75-78).

    Domain-separated Poseidon2 over the length-prefixed UTF-8 name,
    packed as little-endian u32 felts. Framework-reserved ids (0, 1, 2)
    are remapped by flipping a high bit, preserving stability.
    """
    data = f"miden-tpu-precompile-id:{len(name)}:{name}".encode()
    felts = _bytes_to_packed_u32(data)
    pid = hp.hash_elements(felts)[0]
    if pid in (TAG_TRUE_ID, TAG_AND_ID, TAG_CHUNKS_ID):
        pid |= 1 << 32
    return pid


def _bytes_to_packed_u32(data: bytes) -> list[int]:
    out = []
    for i in range(0, len(data), 4):
        out.append(int.from_bytes(data[i : i + 4], "little"))
    return out


# ---------------------------------------------------------------------------
# Tag
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tag:
    """Precompile id + three local immediates, hashed as [id, a0, a1, a2]."""

    id: int
    args: tuple = (0, 0, 0)

    def __post_init__(self):
        assert len(self.args) == 3
        object.__setattr__(self, "args", tuple(int(a) % P for a in self.args))
        object.__setattr__(self, "id", int(self.id) % P)

    @property
    def is_framework_reserved(self) -> bool:
        return self.id in (TAG_TRUE_ID, TAG_AND_ID, TAG_CHUNKS_ID)

    def as_word(self) -> tuple:
        return (self.id, *self.args)

    @staticmethod
    def from_word(w) -> "Tag":
        return Tag(w[0], (w[1], w[2], w[3]))

    @staticmethod
    def precompile(pid: int, args=(0, 0, 0)) -> "Tag":
        tag = Tag(pid, tuple(args))
        if tag.is_framework_reserved:
            raise DeferredError("framework-reserved precompile id")
        return tag


TAG_TRUE = Tag(TAG_TRUE_ID)
TAG_AND = Tag(TAG_AND_ID)
TAG_CHUNKS = Tag(TAG_CHUNKS_ID)


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------

#: declared framework payload shapes (node.rs NodeType)
TRUE, DATA, JOIN, PAIR_LIST = "true", "data", "join", "pair_list"


@dataclass(frozen=True)
class Node:
    """A deferred DAG entry: tag + payload chunks + declared shape.

    ``kind`` is the framework shape (node.rs NodeType): ``data`` payloads
    are opaque chunks; ``join`` is one chunk holding two child digests
    ``lhs || rhs``; ``pair_list`` is one chunk per structural digest
    pair. All kinds share the canonical chunk-sponge digest.
    """

    tag: Tag
    kind: str
    chunks: tuple  # tuple of 8-felt tuples

    # -- constructors ------------------------------------------------------

    @staticmethod
    def true_node() -> "Node":
        return Node(TAG_TRUE, TRUE, ())

    @staticmethod
    def data(tag: Tag, chunks) -> "Node":
        chunks = tuple(tuple(int(v) % P for v in c) for c in chunks)
        if not chunks or any(len(c) != 8 for c in chunks):
            raise DeferredError("data payload must be non-empty 8-felt chunks")
        if tag.is_framework_reserved and tag != TAG_CHUNKS:
            raise DeferredError("framework-reserved tag")
        return Node(tag, DATA, chunks)

    @staticmethod
    def chunks_node(chunks) -> "Node":
        """Framework-owned opaque chunk-list data node (Tag::CHUNKS)."""
        return Node.data(TAG_CHUNKS, chunks)

    @staticmethod
    def chunks_from_bytes(data: bytes) -> "Node":
        """Packs little-endian bytes into u32 felts, zero-padded to a
        non-empty whole number of chunks (node.rs:365-374)."""
        felts = _bytes_to_packed_u32(data)
        n_chunks = max(1, -(-len(felts) // 8))
        felts += [0] * (n_chunks * 8 - len(felts))
        return Node.chunks_node(
            [tuple(felts[8 * i : 8 * i + 8]) for i in range(n_chunks)]
        )

    @staticmethod
    def join(tag: Tag, lhs: Digest, rhs: Digest) -> "Node":
        if tag.is_framework_reserved and tag != TAG_AND:
            raise DeferredError("framework-reserved tag")
        chunk = tuple(int(v) % P for v in (*lhs, *rhs))
        return Node(tag, JOIN, (chunk,))

    @staticmethod
    def and_node(lhs: Digest, rhs: Digest) -> "Node":
        """Structural deferred-root AND step (node.rs:407-413)."""
        return Node.join(TAG_AND, lhs, rhs)

    @staticmethod
    def pair_list(tag: Tag, pairs) -> "Node":
        if tag.is_framework_reserved:
            raise DeferredError("framework-reserved tag")
        if not pairs:
            raise DeferredError("pair list must be non-empty")
        chunks = tuple(
            tuple(int(v) % P for v in (*l, *r)) for (l, r) in pairs
        )
        return Node(tag, PAIR_LIST, chunks)

    # -- accessors ---------------------------------------------------------

    @property
    def is_true(self) -> bool:
        return self.kind == TRUE

    def as_join(self) -> tuple:
        if self.kind != JOIN:
            raise DeferredError("not a join node")
        (c,) = self.chunks
        return tuple(c[0:4]), tuple(c[4:8])

    def as_pairs(self) -> list:
        if self.kind != PAIR_LIST:
            raise DeferredError("not a pair-list node")
        return [(tuple(c[0:4]), tuple(c[4:8])) for c in self.chunks]

    def children(self) -> list:
        """Structural child digests in payload order."""
        if self.kind == JOIN:
            return list(self.as_join())
        if self.kind == PAIR_LIST:
            return [d for pr in self.as_pairs() for d in pr]
        return []

    def storage_felt_len(self) -> int:
        """Budget footprint: tag word + chunks (node.rs:456-469)."""
        return 0 if self.is_true else 4 + 8 * len(self.chunks)

    def digest(self) -> Digest:
        """Canonical content address (node.rs:487-501)."""
        if self.is_true:
            return TRUE_DIGEST
        state = [0] * 8 + [v % P for v in self.tag.as_word()]
        for chunk in self.chunks:
            state[0:8] = [v % P for v in chunk]
            state = hp.permute(state)
        return tuple(state[0:4])


def sponge_digest(tag_word, chunks) -> Digest:
    """The canonical chunk-sponge digest without building a Node."""
    state = [0] * 8 + [int(v) % P for v in tag_word]
    for chunk in chunks:
        state[0:8] = [int(v) % P for v in chunk]
        state = hp.permute(state)
    return tuple(state[0:4])


# ---------------------------------------------------------------------------
# Precompile protocol + registry
# ---------------------------------------------------------------------------


class Precompile:
    """Owner of a tag-id namespace (precompile.rs trait Precompile).

    ``decode`` declares the framework shape for recognized local args
    (None rejects); ``evaluate`` reduces one owned node to canonical
    form — predicates return ``Node.true_node()`` on success.
    """

    name: str = ""
    id: int = 0

    def init_nodes(self) -> list:
        return []

    def decode(self, args) -> str | None:
        raise NotImplementedError

    def evaluate(self, args, node: Node, ctx: "DeferredContext") -> Node:
        raise NotImplementedError


class PrecompileRegistry:
    """Id-keyed precompile set (precompile_registry.rs)."""

    def __init__(self, precompiles=()):
        self._by_id: dict[int, Precompile] = {}
        for pc in precompiles:
            self.add(pc)

    def add(self, pc: Precompile) -> "PrecompileRegistry":
        if pc.id in (TAG_TRUE_ID, TAG_AND_ID, TAG_CHUNKS_ID):
            raise DeferredError(f"precompile id {pc.id} is framework-reserved")
        if pc.id in self._by_id:
            raise DeferredError(f"duplicate precompile id {pc.id}")
        self._by_id[pc.id] = pc
        return self

    def merge(self, other: "PrecompileRegistry") -> None:
        for pc in other._by_id.values():
            self.add(pc)

    def get(self, pid: int) -> Precompile | None:
        return self._by_id.get(pid)

    def init_nodes(self) -> list:
        out = []
        for pc in self._by_id.values():
            out.extend(pc.init_nodes())
        return out

    def decode_node_type(self, tag: Tag) -> str:
        """Declared framework shape for a tag (registry dispatch)."""
        if tag == TAG_TRUE:
            return TRUE
        if tag.id == TAG_AND_ID:
            if tag != TAG_AND:
                raise DeferredError("AND tag carries no args")
            return JOIN
        if tag.id == TAG_CHUNKS_ID:
            if tag != TAG_CHUNKS:
                raise DeferredError("CHUNKS tag carries no args")
            return DATA
        pc = self._by_id.get(tag.id)
        if pc is None:
            raise DeferredError(f"unknown precompile id {tag.id}")
        shape = pc.decode(tag.args)
        if shape is None:
            raise DeferredError(f"precompile {pc.name} rejected tag args")
        return shape

    def validate_node(self, node: Node) -> str:
        shape = self.decode_node_type(node.tag)
        if shape != node.kind:
            raise DeferredError(
                f"node shape {node.kind} does not match declared {shape}"
            )
        return shape

    def evaluate(self, node: Node, ctx: "DeferredContext") -> Node:
        pc = self._by_id.get(node.tag.id)
        if pc is None:
            raise DeferredError(f"unknown precompile id {node.tag.id}")
        return pc.evaluate(node.tag.args, node, ctx)


# ---------------------------------------------------------------------------
# Deferred state
# ---------------------------------------------------------------------------


class DeferredContext:
    """Capability handle passed to precompile evaluation (state.rs:358)."""

    def __init__(self, state: "DeferredState"):
        self._state = state

    def get_node(self, digest: Digest) -> Node | None:
        return self._state.get_node(digest)

    def evaluate_digest(self, digest: Digest) -> Digest:
        return self._state.evaluate_digest(digest)

    def ensure_equal(self, lhs: Digest, rhs: Digest) -> None:
        if self.evaluate_digest(lhs) != self.evaluate_digest(rhs):
            raise DeferredError("deferred assertion failed")

    def register(self, node: Node) -> Digest:
        return self._state.register(node)


class DeferredState:
    """In-memory witness for deferred-DAG verification (state.rs).

    Keeps registered nodes, evaluation memos, the rolling deferred root,
    and a felt budget. ``register`` validates + eagerly evaluates;
    ``log_statement`` advances the root with a framework AND node after
    proving both sides evaluate to TRUE.
    """

    def __init__(self, registry: PrecompileRegistry | None = None,
                 max_elements: int = 1 << 62):
        self.registry = registry or PrecompileRegistry()
        self.nodes: dict[Digest, Node] = {TRUE_DIGEST: Node.true_node()}
        self.evals: dict[Digest, Digest] = {TRUE_DIGEST: TRUE_DIGEST}
        self.root: Digest = TRUE_DIGEST
        self.remaining_elements = max_elements
        for node in self.registry.init_nodes():
            self.register(node)

    # -- queries -----------------------------------------------------------

    def get_node(self, digest: Digest) -> Node | None:
        return self.nodes.get(tuple(digest))

    def get_canonical_node(self, digest: Digest):
        cd = self.evals.get(tuple(digest))
        if cd is None or cd not in self.nodes:
            return None
        return cd, self.nodes[cd]

    # -- mutation ----------------------------------------------------------

    def _validate_for_insertion(self, node: Node) -> None:
        self.registry.validate_node(node)
        for child in node.children():
            if tuple(child) != TRUE_DIGEST and tuple(child) not in self.nodes:
                raise DeferredError("dangling structural child reference")

    def _insert(self, node: Node) -> Digest:
        digest = node.digest()
        existing = self.nodes.get(digest)
        if existing is not None:
            if existing != node:
                raise DeferredError("conflicting node for digest")
            return digest
        required = node.storage_felt_len()
        if required > self.remaining_elements:
            raise IntegrityError(
                f"deferred state budget exceeded ({required} felts needed, "
                f"{self.remaining_elements} remain)"
            )
        self.remaining_elements -= required
        self.nodes[digest] = node
        return digest

    def register(self, node: Node) -> Digest:
        """Validate, store, and eagerly evaluate a node (state.rs:182)."""
        self._validate_for_insertion(node)
        digest = self._insert(node)
        self.evaluate_digest(digest)
        return digest

    def evaluate_digest(self, digest: Digest) -> Digest:
        digest = tuple(digest)
        node = self.nodes.get(digest)
        if node is None:
            raise DeferredError("missing node")
        memo = self.evals.get(digest)
        if memo is not None:
            if memo not in self.nodes:
                raise DeferredError("dangling evaluation memo")
            return memo

        self._validate_for_insertion(node)
        if node.tag == TAG_TRUE:
            canonical = Node.true_node()
        elif node.tag == TAG_AND:
            lhs, rhs = node.as_join()
            for child in (lhs, rhs):
                self._require_true(child)
            canonical = Node.true_node()
        elif node.tag == TAG_CHUNKS:
            canonical = node
        else:
            canonical = self.registry.evaluate(node, DeferredContext(self))

        self._validate_for_insertion(canonical)
        cd = self._insert(canonical)
        prev = self.evals.get(digest)
        if prev is not None and prev != cd:
            raise DeferredError("conflicting evaluation memo")
        self.evals[digest] = cd
        return cd

    def _require_true(self, digest: Digest) -> None:
        if self.evaluate_digest(digest) != TRUE_DIGEST:
            raise DeferredError("deferred node did not evaluate to TRUE")

    def log_statement(self, statement_digest: Digest) -> Digest:
        """AND-fold a proven statement into the root (state.rs:194)."""
        statement_digest = tuple(statement_digest)
        self._require_true(self.root)
        self._require_true(statement_digest)
        and_node = Node.and_node(self.root, statement_digest)
        new_root = self._insert(and_node)
        self.root = new_root
        self.evals[new_root] = TRUE_DIGEST
        return new_root

    def log_verified_statement(
        self, statement_digest: Digest, expected_new_root: Digest
    ) -> Digest:
        """Binds a LOGDEFERRED-constrained transition to the DAG
        (state.rs:214): the expected root must equal the AND fold."""
        actual = Node.and_node(self.root, tuple(statement_digest)).digest()
        if actual != tuple(expected_new_root):
            raise DeferredError("invalid deferred root transition")
        return self.log_statement(statement_digest)

    # -- wire --------------------------------------------------------------

    def to_wire(self) -> "DeferredStateWire":
        return DeferredStateWire.from_state(self)

    @staticmethod
    def from_wire(
        registry: PrecompileRegistry,
        wire: "DeferredStateWire",
        max_elements: int = 1 << 62,
    ) -> "DeferredState":
        return wire.rehydrate(registry, max_elements)


# ---------------------------------------------------------------------------
# Wire form
# ---------------------------------------------------------------------------

TRUE_INDEX = 0

WIRE_MAGIC = b"MTDW"
WIRE_VERSION = 1
MAX_WIRE_BYTES = 16 * 1024 * 1024
MAX_WIRE_ENTRIES = 1 << 20
MAX_WIRE_CHUNKS = 1 << 16

_KIND_DATA, _KIND_JOIN, _KIND_PAIRS = 0, 1, 2


@dataclass(frozen=True)
class WireEntry:
    kind: str  # DATA | JOIN | PAIR_LIST
    tag: Tag
    chunks: tuple = ()  # DATA payload chunks
    refs: tuple = ()  # JOIN: (lhs, rhs); PAIR_LIST: ((l, r), ...)


@dataclass
class DeferredStateWire:
    """Canonical topological root-last entry stream (wire.rs)."""

    entries: list = field(default_factory=list)

    # -- encode ------------------------------------------------------------

    @staticmethod
    def from_state(state: DeferredState) -> "DeferredStateWire":
        """Root-reachable closure in canonical post-order DFS
        (wire.rs:310-366); orphans are dropped."""
        by_digest: dict[Digest, int] = {}
        entries: list[WireEntry] = []
        seen: set[Digest] = set()

        def index_for(digest: Digest) -> int:
            if digest == TRUE_DIGEST:
                return TRUE_INDEX
            return by_digest[digest]

        # iterative post-order DFS, children in payload order
        pending = [("visit", state.root)]
        while pending:
            op, digest = pending.pop()
            if op == "visit":
                if digest == TRUE_DIGEST or digest in seen:
                    continue
                node = state.get_node(digest)
                if node is None:
                    raise IntegrityError("root-reachable node missing")
                state.registry.validate_node(node)
                seen.add(digest)
                pending.append(("emit", digest))
                for child in reversed(node.children()):
                    pending.append(("visit", tuple(child)))
            else:
                node = state.nodes[digest]
                if node.kind == DATA:
                    entry = WireEntry(DATA, node.tag, node.chunks)
                elif node.kind == JOIN:
                    lhs, rhs = node.as_join()
                    entry = WireEntry(
                        JOIN, node.tag, (), (index_for(lhs), index_for(rhs))
                    )
                elif node.kind == PAIR_LIST:
                    entry = WireEntry(
                        PAIR_LIST,
                        node.tag,
                        (),
                        tuple(
                            (index_for(l), index_for(r))
                            for l, r in node.as_pairs()
                        ),
                    )
                else:
                    raise IntegrityError("TRUE cannot be an explicit entry")
                by_digest[digest] = len(entries) + 1
                entries.append(entry)
        return DeferredStateWire(entries)

    # -- decode ------------------------------------------------------------

    def rehydrate(
        self, registry: PrecompileRegistry, max_elements: int = 1 << 62
    ) -> DeferredState:
        """Strict rehydration (wire.rs:90-122): decode, register in wire
        order, require byte-canonical re-encoding, evaluate root to TRUE."""
        index_to_digest: list[Digest] = [TRUE_DIGEST]
        seen: set[Digest] = {TRUE_DIGEST}
        decoded: list[tuple[Digest, Node]] = []

        def resolve(idx: int) -> Digest:
            if not 0 <= idx < len(index_to_digest):
                raise IntegrityError("wire child reference out of range")
            return index_to_digest[idx]

        for entry in self.entries:
            try:
                if entry.kind == DATA:
                    if entry.tag == TAG_CHUNKS:
                        node = Node.chunks_node(entry.chunks)
                    else:
                        node = Node.data(entry.tag, entry.chunks)
                elif entry.kind == JOIN:
                    lhs, rhs = (resolve(i) for i in entry.refs)
                    if entry.tag == TAG_AND:
                        node = Node.and_node(lhs, rhs)
                    else:
                        node = Node.join(entry.tag, lhs, rhs)
                elif entry.kind == PAIR_LIST:
                    node = Node.pair_list(
                        entry.tag,
                        [(resolve(l), resolve(r)) for l, r in entry.refs],
                    )
                else:
                    raise IntegrityError("unknown wire entry kind")
            except IntegrityError:
                raise
            except DeferredError as e:
                # malformed entries reject uniformly: callers filter on
                # IntegrityError (fuzz finding, tests/test_fuzz_decoders)
                raise IntegrityError(str(e)) from e
            try:
                shape = registry.decode_node_type(node.tag)
            except DeferredError as e:
                raise IntegrityError(str(e)) from e
            if shape != node.kind:
                raise IntegrityError("wire entry shape mismatch")
            digest = node.digest()
            if digest in seen:
                raise IntegrityError("duplicate wire entry")
            seen.add(digest)
            index_to_digest.append(digest)
            decoded.append((digest, node))

        state = DeferredState(registry, max_elements)
        try:
            for digest, node in decoded:
                if state.register(node) != digest:
                    raise IntegrityError("wire digest mismatch")
        except DeferredError as e:
            raise IntegrityError(str(e)) from e
        state.root = index_to_digest[-1]

        if state.to_wire() != self:
            raise IntegrityError("non-canonical deferred wire")
        try:
            if state.evaluate_digest(state.root) != TRUE_DIGEST:
                raise IntegrityError("deferred root is not TRUE")
        except DeferredError as e:
            raise IntegrityError(str(e)) from e
        return state

    # -- bytes -------------------------------------------------------------

    def to_bytes(self) -> bytes:
        out = bytearray(WIRE_MAGIC)
        out += struct.pack("<BI", WIRE_VERSION, len(self.entries))
        for entry in self.entries:
            kind = {DATA: _KIND_DATA, JOIN: _KIND_JOIN, PAIR_LIST: _KIND_PAIRS}[
                entry.kind
            ]
            out += struct.pack("<B4Q", kind, *entry.tag.as_word())
            if entry.kind == DATA:
                out += struct.pack("<I", len(entry.chunks))
                for chunk in entry.chunks:
                    out += struct.pack("<8Q", *chunk)
            elif entry.kind == JOIN:
                out += struct.pack("<II", *entry.refs)
            else:
                out += struct.pack("<I", len(entry.refs))
                for l, r in entry.refs:
                    out += struct.pack("<II", l, r)
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "DeferredStateWire":
        """Budgeted structural decode (caps before allocation, like
        vm/mast_io.py); canonical validation happens in rehydrate."""
        if len(data) > MAX_WIRE_BYTES:
            raise IntegrityError("deferred wire exceeds byte budget")
        if data[:4] != WIRE_MAGIC:
            raise IntegrityError("bad deferred wire magic")
        pos = 4
        try:
            version, n_entries = struct.unpack_from("<BI", data, pos)
            pos += 5
            if version != WIRE_VERSION:
                raise IntegrityError("unsupported deferred wire version")
            if n_entries > MAX_WIRE_ENTRIES:
                raise IntegrityError("deferred wire entry budget exceeded")
            entries = []
            for _ in range(n_entries):
                kind, t0, t1, t2, t3 = struct.unpack_from("<B4Q", data, pos)
                pos += 33
                if max(t0, t1, t2, t3) >= P:
                    raise IntegrityError("non-canonical tag felt")
                tag = Tag.from_word((t0, t1, t2, t3))
                if kind == _KIND_DATA:
                    (n_chunks,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    if n_chunks > MAX_WIRE_CHUNKS:
                        raise IntegrityError("wire chunk budget exceeded")
                    chunks = []
                    for _ in range(n_chunks):
                        vals = struct.unpack_from("<8Q", data, pos)
                        pos += 64
                        if max(vals) >= P:
                            raise IntegrityError("non-canonical chunk felt")
                        chunks.append(vals)
                    entries.append(WireEntry(DATA, tag, tuple(chunks)))
                elif kind == _KIND_JOIN:
                    lhs, rhs = struct.unpack_from("<II", data, pos)
                    pos += 8
                    entries.append(WireEntry(JOIN, tag, (), (lhs, rhs)))
                elif kind == _KIND_PAIRS:
                    (n_pairs,) = struct.unpack_from("<I", data, pos)
                    pos += 4
                    if n_pairs > MAX_WIRE_CHUNKS:
                        raise IntegrityError("wire pair budget exceeded")
                    pairs = []
                    for _ in range(n_pairs):
                        l, r = struct.unpack_from("<II", data, pos)
                        pos += 8
                        pairs.append((l, r))
                    entries.append(WireEntry(PAIR_LIST, tag, (), tuple(pairs)))
                else:
                    raise IntegrityError("unknown wire entry kind")
        except struct.error as e:
            raise IntegrityError("truncated deferred wire") from e
        if pos != len(data):
            raise IntegrityError("trailing bytes after deferred wire")
        return DeferredStateWire(entries)


# ---------------------------------------------------------------------------
# In-tree precompiles (u256 add/mul, keccak merge, keccak arbitrary-length)
# ---------------------------------------------------------------------------


def u256_value_node(x: int) -> Node:
    """CHUNKS node of a u256's 32 little-endian bytes (one chunk of 8
    packed-u32 limbs); its digest is the operand hash committed by the
    session chiplets: P([limbs32(x), 2, 0, 0, 0])[0:4]."""
    assert 0 <= x < (1 << 256)
    return Node.chunks_from_bytes(x.to_bytes(32, "little"))


def ec_point_node(x: int, y: int) -> Node:
    """CHUNKS node of an affine secp256k1 point's 64 little-endian bytes
    (x || y, two chunks of 8 packed-u32 limbs each); its digest is the
    two-absorb sponge the EC session chiplet re-derives
    (precompile/ec.py). The pair (0, 0) is the point-at-infinity
    sentinel — it is not on the curve (0³ + 7 ≠ 0 mod p), mirroring the
    reference's explicit ``is_pai`` flag with none-sentinel ptrs
    (precompiles-prover/src/ec/mod.rs point rows)."""
    assert 0 <= x < (1 << 256) and 0 <= y < (1 << 256)
    return Node.chunks_from_bytes(
        x.to_bytes(32, "little") + y.to_bytes(32, "little")
    )


def ec_point_value(node: Node) -> tuple:
    """Inverse of :func:`ec_point_node`: decode a two-chunk point node."""
    if node.tag != TAG_CHUNKS or len(node.chunks) != 2:
        raise DeferredError("EC point operand must be a two-chunk value")
    vals = []
    for chunk in node.chunks:
        if any(int(v) >> 32 for v in chunk):
            raise DeferredError("EC point limbs exceed u32")
        vals.append(sum(int(v) << (32 * i) for i, v in enumerate(chunk)))
    return tuple(vals)


def binop_statement_node(pid: int, a: Digest, b: Digest, out: Digest) -> Node:
    """Statement shape shared by u256 add/mul and keccak merge: a
    pair-list ``[(a, b), (out, TRUE)]`` under tag [pid, 0, 0, 0]. Its
    canonical digest is the two-absorb sponge the chain AIR constrains:
    ``s1 = P([ha, hb, pid, 0, 0, 0]); stmt = P([ho, 0^4, s1[8:12]])``."""
    return Node.pair_list(Tag.precompile(pid), [(a, b), (out, TRUE_DIGEST)])


def keccak_message_chunks(message: bytes) -> list:
    """Keccak-rate-aligned chunking for arbitrary-length messages.

    DIVERGENCE from the reference's dense 32-byte chunking
    (node.rs:365-374): each 136-byte keccak rate block maps to exactly
    five chunks (4 x 32 B + 8 B zero-padded), and the chunk count is
    always ``5 * ceil((len+1)/136)``. This keeps every chunk derivable
    from one keccak-f cycle's message bits, so the in-circuit sponge
    (precompile/sponge.py) and keccak chiplet exchange chunks with
    purely local constraints. The message length lives in the statement
    tag, so equal chunk lists at different lengths cannot collide.
    """
    n_blocks = max(1, -(-(len(message) + 1) // 136))
    chunks = []
    for j in range(n_blocks):
        block = message[136 * j : 136 * (j + 1)]
        block = block + b"\x00" * (136 - len(block))
        for c in range(4):
            felts = _bytes_to_packed_u32(block[32 * c : 32 * (c + 1)])
            chunks.append(tuple(felts))
        felts = _bytes_to_packed_u32(block[128:136])
        chunks.append(tuple(felts + [0] * 6))
    return chunks


def keccak_statement_node(message: bytes, out_node_digest: Digest) -> tuple:
    """(message_node, statement_node) for an arbitrary-length keccak256
    claim: statement = Join(tag=[PID_KECCAK256, len, 0, 0], msg, out),
    digest = P([hm, ho, 6, len, 0, 0])[0:4]."""
    msg_node = Node.chunks_node(keccak_message_chunks(message))
    stmt = Node.join(
        Tag.precompile(PID_KECCAK256, (len(message), 0, 0)),
        msg_node.digest(),
        out_node_digest,
    )
    return msg_node, stmt


class _BinopPrecompile(Precompile):
    """Host evaluator for the pair-list binop statements."""

    def __init__(self, name, pid, semantics):
        self.name, self.id, self._semantics = name, pid, semantics

    def decode(self, args):
        return PAIR_LIST if tuple(args) == (0, 0, 0) else None

    def evaluate(self, args, node, ctx):
        (a_d, b_d), (out_d, true_d) = node.as_pairs()
        if tuple(true_d) != TRUE_DIGEST:
            raise DeferredError("malformed binop statement")
        operands = []
        for d in (a_d, b_d, out_d):
            child = ctx.get_node(tuple(d))
            if child is None or child.tag != TAG_CHUNKS or len(child.chunks) != 1:
                raise DeferredError("binop operand must be a one-chunk value")
            (chunk,) = child.chunks
            if any(v >> 32 for v in chunk):
                raise DeferredError("operand limbs exceed u32")
            operands.append(
                sum(int(v) << (32 * i) for i, v in enumerate(chunk))
            )
        a, b, out = operands
        if self._semantics(a, b) != out:
            raise DeferredError(f"{self.name} claim is false")
        return Node.true_node()


class _KeccakPrecompile(Precompile):
    """Host evaluator for arbitrary-length keccak256 statements."""

    name = "miden::keccak256"
    id = PID_KECCAK256

    def decode(self, args):
        length, z1, z2 = args
        return JOIN if (z1, z2) == (0, 0) and length < MAX_WIRE_BYTES else None

    def evaluate(self, args, node, ctx):
        from ..hash.keccak_host import keccak256

        length = int(args[0])
        msg_d, out_d = node.as_join()
        msg_node = ctx.get_node(tuple(msg_d))
        out_node = ctx.get_node(tuple(out_d))
        if (
            msg_node is None
            or out_node is None
            or msg_node.tag != TAG_CHUNKS
            or out_node.tag != TAG_CHUNKS
            or len(out_node.chunks) != 1
        ):
            raise DeferredError("malformed keccak statement")
        expected_chunks = 5 * max(1, -(-(length + 1) // 136))
        if len(msg_node.chunks) != expected_chunks:
            raise DeferredError("keccak message chunk count mismatch")
        data = bytearray()
        for chunk in msg_node.chunks:
            for v in chunk:
                if v >> 32:
                    raise DeferredError("message limbs exceed u32")
                data += int(v).to_bytes(4, "little")
        # recover the raw message: block j bytes live at chunk offsets
        message = bytearray()
        for j in range(expected_chunks // 5):
            group = data[160 * j : 160 * (j + 1)]
            message += group[0:136]  # chunks 0-3 = 128 B, chunk 4 = 8 B + pad
        if any(message[length:]):
            raise DeferredError("nonzero padding beyond message length")
        message = bytes(message[:length])
        if tuple(msg_node.chunks) != tuple(keccak_message_chunks(message)):
            raise DeferredError("non-canonical keccak message chunking")
        (out_chunk,) = out_node.chunks
        if any(v >> 32 for v in out_chunk):
            raise DeferredError("digest limbs exceed u32")
        digest = b"".join(int(v).to_bytes(4, "little") for v in out_chunk)
        if keccak256(message) != digest:
            raise DeferredError("keccak256 claim is false")
        return Node.true_node()


class _EcPrecompile(Precompile):
    """Host evaluator for the secp256k1 group-law statements.

    Covers the reference's EC precompile family
    (precompiles-prover/src/ec/: add + msm chiplets over the point /
    group stores) at claim granularity: ``PID_EC_ADD`` states
    ``out = a + b`` under the complete affine group law with the (0, 0)
    infinity sentinel; ``PID_EC_MUL`` states ``out = [k]·P`` for an
    arbitrary 256-bit integer scalar (double-and-add semantics).
    Finite operands must be canonical (coordinates < p) and on-curve.
    """

    def __init__(self, name, pid):
        self.name, self.id = name, pid

    def decode(self, args):
        return PAIR_LIST if tuple(args) == (0, 0, 0) else None

    def evaluate(self, args, node, ctx):
        (a_d, b_d), (out_d, true_d) = node.as_pairs()
        if tuple(true_d) != TRUE_DIGEST:
            raise DeferredError("malformed EC statement")
        children = []
        for d in (a_d, b_d, out_d):
            child = ctx.get_node(tuple(d))
            if child is None:
                raise DeferredError("EC operand node missing")
            children.append(child)
        if self.id == PID_EC_MUL:
            scalar_node = children[0]
            if (
                scalar_node.tag != TAG_CHUNKS
                or len(scalar_node.chunks) != 1
            ):
                raise DeferredError("EC scalar must be a one-chunk value")
            (chunk,) = scalar_node.chunks
            if any(int(v) >> 32 for v in chunk):
                raise DeferredError("EC scalar limbs exceed u32")
            k = sum(int(v) << (32 * i) for i, v in enumerate(chunk))
            pts = [ec_point_value(c) for c in children[1:]]
        else:
            k = None
            pts = [ec_point_value(c) for c in children]
        for pt in pts[:-1] if self.id == PID_EC_ADD else pts[:1]:
            if pt != (0, 0):
                if not (pt[0] < EC_P and pt[1] < EC_P):
                    raise DeferredError("EC point coordinate not canonical")
                if not _ec_on_curve(pt):
                    raise DeferredError("EC operand not on secp256k1")
        if self.id == PID_EC_ADD:
            expected = secp256k1_complete_add(pts[0], pts[1])
            if pts[2] != expected:
                raise DeferredError("EC add claim is false")
        else:
            expected = secp256k1_scalar_mul(k, pts[0])
            if pts[1] != expected:
                raise DeferredError("EC mul claim is false")
        return Node.true_node()


def _ec_on_curve(pt) -> bool:
    x, y = pt
    return (y * y - x * x * x - 7) % EC_P == 0


def secp256k1_complete_add(p, q) -> tuple:
    """Complete affine group law on secp256k1 with the (0, 0) infinity
    sentinel (host twin of the EcOpAir case split, precompile/ec.py)."""
    if p == (0, 0):
        return tuple(q)
    if q == (0, 0):
        return tuple(p)
    x1, y1 = p
    x2, y2 = q
    if x1 % EC_P == x2 % EC_P:
        if (y1 + y2) % EC_P == 0:
            return (0, 0)
        lam = 3 * x1 * x1 * _inv(2 * y1, EC_P) % EC_P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, EC_P) % EC_P
    x3 = (lam * lam - x1 - x2) % EC_P
    y3 = (lam * (x1 - x3) - y1) % EC_P
    return (x3, y3)


def secp256k1_scalar_mul(k: int, p) -> tuple:
    """[k]·P by complete double-and-add (msb-first), matching the EC mul
    chiplet's step chain row-for-row."""
    acc = (0, 0)
    for i in reversed(range(256)):
        acc = secp256k1_complete_add(acc, acc)
        if (k >> i) & 1:
            acc = secp256k1_complete_add(acc, p)
    return acc


def default_registry() -> PrecompileRegistry:
    """Registry with the in-tree precompiles installed."""
    mask = (1 << 256) - 1
    return PrecompileRegistry(
        [
            _BinopPrecompile(
                "miden::u256::add", PID_U256_ADD, lambda a, b: (a + b) & mask
            ),
            _BinopPrecompile(
                "miden::u256::mul", PID_U256_MUL, lambda a, b: (a * b) & mask
            ),
            _BinopPrecompile(
                "miden::keccak256::merge",
                PID_KECCAK_MERGE,
                _keccak_merge_semantics,
            ),
            _KeccakPrecompile(),
            _EcPrecompile("miden::secp256k1::add", PID_EC_ADD),
            _EcPrecompile("miden::secp256k1::mul", PID_EC_MUL),
        ]
    )


def _keccak_merge_semantics(a: int, b: int) -> int:
    from ..hash.keccak_host import keccak256

    msg = a.to_bytes(32, "little") + b.to_bytes(32, "little")
    return int.from_bytes(keccak256(msg), "little")
