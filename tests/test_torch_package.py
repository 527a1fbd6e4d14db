"""The port's ``.masp`` packages (``miden_tpu_torch.vm.package``) ≡ ``miden_tpu``'s.

The cases of ``tests/test_package.py`` on the port; the wire bytes of both
packages equal and each decodes the other's. The port's decoder is the
repaired one: every malformed input raises ``MastFormatError``, where
``miden_tpu``'s lets ``struct.error`` and ``UnicodeDecodeError`` escape
(pinned below, so that these tests fail once ``miden_tpu`` is repaired).
"""

import struct

import pytest

from miden_tpu.vm import package as j_package
from miden_tpu_torch.vm.mast_io import MastFormatError
from miden_tpu_torch.vm.package import MastPackage, assemble_library_package, assemble_program_package
from miden_tpu_torch.vm.processor import execute

LIB = {
    "math::double": """
pub proc double
    add.0 mul.2
end

proc helper
    add.1
end

pub proc double_plus_one
    exec.helper mul.2
end
""",
}


def test_program_package_roundtrip(tmp_path):
    pkg = assemble_program_package("fib-demo", "begin push.1 push.2 add end", version="1.2.3")
    assert pkg.kind == "program" and pkg.exports[0][0] == "main"
    path = tmp_path / "demo.masp"
    pkg.save(path)
    back = MastPackage.load(path)
    assert back.name == "fib-demo" and back.version == "1.2.3"
    assert back.digest == pkg.digest
    assert int(execute(back.program(), []).stack[0]) == 3


def test_library_package_exports_and_digest():
    pkg = assemble_library_package("mathlib", LIB)
    names = [n for n, _ in pkg.exports]
    assert names == ["math::double::double", "math::double::double_plus_one"]
    back = MastPackage.from_bytes(pkg.to_bytes())
    assert back.exports == pkg.exports and back.digest == pkg.digest
    flipped = MastPackage(
        name=pkg.name, version=pkg.version, kind="library", forest=pkg.forest,
        exports=tuple(reversed(pkg.exports)),
    )
    assert flipped.digest == pkg.digest


@pytest.mark.parametrize("kind", ["program", "library"])
def test_package_bytes_equal_miden_tpu_and_decode_across(kind):
    if kind == "program":
        args = ("fib", "begin push.0 push.1 repeat.10 swap dup.1 add end swap drop swap drop end")
        mine, theirs = assemble_program_package(*args, description="d"), j_package.assemble_program_package(
            *args, description="d")
    else:
        mine, theirs = assemble_library_package("mathlib", LIB), j_package.assemble_library_package("mathlib", LIB)
    data = mine.to_bytes()
    assert data == theirs.to_bytes()
    assert mine.digest == theirs.digest
    back, j_back = MastPackage.from_bytes(theirs.to_bytes()), j_package.MastPackage.from_bytes(data)
    assert back.to_bytes() == j_back.to_bytes() == data
    if kind == "program":
        assert tuple(back.program().hash) == tuple(j_back.program().hash)


def test_package_rejects_tampered_manifest():
    data = bytearray(assemble_library_package("mathlib", LIB).to_bytes())
    idx = data.index(b"double_plus_one") + len(b"double_plus_one")
    data[idx + 4] ^= 1
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(bytes(data))


def test_package_rejects_budget_and_garbage():
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(b"MASQ" + b"\x00" * 32)
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(b"MASP" + b"\x00" * (65 * 1024 * 1024))
    data = assemble_program_package("p", "begin push.1 drop end").to_bytes()
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(data[:-3])


def _header_cut(data: bytes) -> bytes:
    """A package cut inside its name field's length."""
    return data[:10]


def _bad_utf8(data: bytes) -> bytes:
    """The first byte of the name replaced with a lone UTF-8 continuation byte."""
    b = bytearray(data)
    b[11] = 0x80
    return bytes(b)


@pytest.mark.parametrize(
    "cut, j_error",
    [(_header_cut, struct.error), (lambda d: d[:6], struct.error), (_bad_utf8, UnicodeDecodeError)],
    ids=["name_length_cut", "header_cut", "bad_utf8"],
)
def test_truncated_or_non_utf8_package_raises_only_mast_format_error(cut, j_error):
    """``miden_tpu``'s decoder lets ``struct.error`` / ``UnicodeDecodeError``
    escape on these bytes (pinned); the port's raises ``MastFormatError``."""
    data = cut(assemble_program_package("prog", "begin push.1 drop end").to_bytes())
    with pytest.raises(j_error):
        j_package.MastPackage.from_bytes(data)
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(data)


def test_library_package_with_an_entrypoint_rejected():
    """A library package carries the 0xFFFFFFFF entrypoint sentinel; the port
    rejects any other value (``miden_tpu`` accepts it)."""
    pkg = assemble_library_package("mathlib", LIB)
    data = bytearray(pkg.to_bytes())
    flen = len(data) - data.index(b"MTFR")
    at = len(data) - flen - 8  # entry u32, then the forest length u32
    assert struct.unpack_from("<I", data, at)[0] == 0xFFFFFFFF
    struct.pack_into("<I", data, at, 0)
    assert j_package.MastPackage.from_bytes(bytes(data)).entrypoint == 0
    with pytest.raises(MastFormatError):
        MastPackage.from_bytes(bytes(data))
