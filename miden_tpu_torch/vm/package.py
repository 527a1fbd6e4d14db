"""MAST packages (.masp): a named, versioned artifact containing a MAST
forest plus its export manifest.

Mirrors the reference's ``miden-mast-package``
(crates/mast-package/src/package/mod.rs ``Package { name, version,
digest, kind, mast, manifest }``): the package digest is the hash of
the export root digests in lexicographic order **by digest** (not by
name), the manifest maps fully-qualified procedure names to MAST
roots, and deserialization is strict + budgeted (untrusted input).
v1 scope: program and library targets, no custom sections or
dependency records (package debug sections are reference-side optional
metadata and are rejected here rather than silently carried).

The wire form is ``miden_tpu``'s byte for byte; the decoder is stricter
(:meth:`MastPackage.from_bytes`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..hash import poseidon2_host as hp
from .assembler import Assembler, AssemblyError, _CompileContext
from .mast import MastForest, Program
from .mast_io import (
    MastFormatError,
    _Reader,
    forest_from_bytes,
    forest_to_bytes,
)

MAGIC = b"MASP"
VERSION = 1

KIND_PROGRAM = 0
KIND_LIBRARY = 1
_KINDS = {KIND_PROGRAM: "program", KIND_LIBRARY: "library"}

#: untrusted-input budgets (package.rs validates against MastForest
#: budgets; these bound the manifest itself)
MAX_NAME_BYTES = 256
MAX_EXPORTS = 1 << 12
MAX_PACKAGE_BYTES = 64 * 1024 * 1024


@dataclass(frozen=True)
class MastPackage:
    """A compiled package: forest + export manifest."""

    name: str
    version: str
    kind: str  # "program" | "library"
    forest: MastForest
    exports: tuple  # ((fq_name, digest_word), ...) in name order
    entrypoint: int | None = None  # program packages only
    description: str = ""

    def __post_init__(self):
        if self.kind not in ("program", "library"):
            raise MastFormatError(f"unknown package kind {self.kind!r}")
        if self.kind == "program" and self.entrypoint is None:
            raise MastFormatError("program package requires an entrypoint")

    @property
    def digest(self) -> tuple:
        """Content hash: export roots in lexicographic order by digest
        (package/mod.rs Package::digest)."""
        roots = sorted(tuple(int(v) for v in d) for _, d in self.exports)
        flat = [v for w in roots for v in w]
        return tuple(hp.hash_elements(flat)) if flat else (0, 0, 0, 0)

    def program(self) -> Program:
        """The executable of a program package."""
        if self.kind != "program":
            raise MastFormatError("not a program package")
        return Program(self.forest, self.entrypoint)

    def export_digest(self, fq_name: str) -> tuple:
        for name, d in self.exports:
            if name == fq_name:
                return tuple(d)
        raise KeyError(fq_name)

    # -- serde -------------------------------------------------------------

    def to_bytes(self) -> bytes:
        out = bytearray()
        out += MAGIC
        kind = KIND_PROGRAM if self.kind == "program" else KIND_LIBRARY
        out += struct.pack("<IB", VERSION, kind)
        for s in (self.name, self.version, self.description):
            data = s.encode()
            if len(data) > MAX_NAME_BYTES:
                raise MastFormatError("package string field too long")
            out += struct.pack("<H", len(data))
            out += data
        out += struct.pack("<I", len(self.exports))
        for name, d in self.exports:
            data = name.encode()
            if len(data) > MAX_NAME_BYTES:
                raise MastFormatError("export name too long")
            out += struct.pack("<H", len(data))
            out += data
            out += struct.pack("<4Q", *(int(v) for v in d))
        out += struct.pack(
            "<I", 0xFFFFFFFF if self.entrypoint is None else self.entrypoint
        )
        forest = forest_to_bytes(self.forest)
        out += struct.pack("<I", len(forest))
        out += forest
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "MastPackage":
        """Strict budgeted decode of an untrusted package. Every malformed
        input raises :class:`MastFormatError`: each field is read through
        the bounds-checked reader of ``mast_io``, a string must be UTF-8,
        and a library package must carry no entrypoint. (``miden_tpu``'s
        decoder lets ``struct.error`` and ``UnicodeDecodeError`` escape on
        truncated or non-UTF-8 input and accepts any library entrypoint.)"""
        if len(data) > MAX_PACKAGE_BYTES:
            raise MastFormatError("package exceeds size budget")
        if data[:4] != MAGIC:
            raise MastFormatError("bad package magic")
        rd = _Reader(data)
        rd.off = 4
        ver, kind = rd.take("<IB")
        if ver != VERSION:
            raise MastFormatError(f"unsupported package version {ver}")
        if kind not in _KINDS:
            raise MastFormatError(f"unknown package kind {kind}")

        def take_str():
            (n,) = rd.take("<H")
            if n > MAX_NAME_BYTES or rd.off + n > len(data):
                raise MastFormatError("string field out of budget")
            try:
                s = bytes(data[rd.off : rd.off + n]).decode()
            except UnicodeDecodeError as e:
                raise MastFormatError("string field is not UTF-8") from e
            rd.off += n
            return s

        name, version, description = take_str(), take_str(), take_str()
        (n_exports,) = rd.take("<I")
        if n_exports > MAX_EXPORTS:
            raise MastFormatError("export count exceeds budget")
        exports = []
        for _ in range(n_exports):
            ename = take_str()
            exports.append((ename, tuple(rd.take("<4Q"))))
        entry, flen = rd.take("<II")
        if rd.off + flen != len(data):
            raise MastFormatError("package length mismatch")
        forest, reader, roots = forest_from_bytes(data[rd.off : rd.off + flen])
        # manifest validation (ManifestValidationError analog): every
        # export digest must be the digest of a forest root
        root_digests = {tuple(int(v) for v in forest[r].digest) for r in roots}
        for ename, d in exports:
            if tuple(int(v) for v in d) not in root_digests:
                raise MastFormatError(
                    f"export {ename!r} is not a forest root"
                )
        entrypoint = None if entry == 0xFFFFFFFF else entry
        if kind == KIND_PROGRAM:
            if entrypoint is None or entrypoint >= len(forest.nodes):
                raise MastFormatError("invalid program entrypoint")
        elif entrypoint is not None:
            raise MastFormatError("library package with an entrypoint")
        return MastPackage(
            name=name,
            version=version,
            kind=_KINDS[kind],
            forest=forest,
            exports=tuple(sorted(exports)),
            entrypoint=entrypoint,
            description=description,
        )

    def save(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @staticmethod
    def load(path) -> "MastPackage":
        with open(path, "rb") as f:
            return MastPackage.from_bytes(f.read())


def assemble_program_package(
    name: str,
    source: str,
    version: str = "0.1.0",
    modules: dict | None = None,
    description: str = "",
) -> MastPackage:
    """Compile an executable module (+ libraries) into a program
    package; the single export is ``main`` → the program hash."""
    asm = Assembler()
    if modules:
        asm.add_library(modules)
    program = asm.assemble_program(source)
    return MastPackage(
        name=name,
        version=version,
        kind="program",
        forest=program.forest,
        exports=(("main", tuple(int(v) for v in program.hash)),),
        entrypoint=program.entrypoint,
        description=description,
    )


def assemble_library_package(
    name: str,
    modules: dict,
    version: str = "0.1.0",
    description: str = "",
) -> MastPackage:
    """Compile every exported procedure of ``modules`` (path → MASM
    source) into one forest; exports are fully-qualified
    ``path::proc`` names mapped to their MAST roots."""
    asm = Assembler()
    asm.add_library(modules)
    forest = MastForest()
    ctx = _CompileContext(asm, forest)
    exports = []
    for path in sorted(modules):
        mod = asm.modules[path]
        for pname, proc in sorted(mod.procs.items()):
            if not proc.exported:
                continue
            node = ctx.compile_proc(mod, pname)
            forest.make_root(node)
            digest = tuple(int(v) for v in forest[node].digest)
            exports.append((f"{path}::{pname}", digest))
    if not exports:
        raise AssemblyError("library package has no exported procedures")
    return MastPackage(
        name=name,
        version=version,
        kind="library",
        forest=forest,
        exports=tuple(exports),
        description=description,
    )
