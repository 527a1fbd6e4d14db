"""The port's precompile session (``miden_tpu_torch.precompile``) ≡ ``miden_tpu``.

Host layer of the second STARK, exact equality with ``miden_tpu`` (Goldilocks
is exact, so there is no tolerance): claim statement digests and deferred
roots, every session trace matrix, the deferred-DAG bridge, the LogUp aux
builder (the port's torch ``build_device_aux`` against ``miden_tpu``'s exact
per-row ``build_numeric_aux``) and the constraint fold (the port's torch
``VectorBackend`` against ``miden_tpu``'s ``ScalarBackend`` at seeded random
points). The port's ``check_air`` accepts every session AIR of a session
holding every claim kind and rejects the tampered traces of ``miden_tpu``'s
own precompile tests. Also here: the stdlib subset (MAST digests, deferred
state of an in-VM ECDSA run and of a ``hash_memory`` run), ``check_core_trace``
and ``verify_program(deferred=...)``. No session is proved here: the proofs
are in ``test_torch_precompile_prove.py`` (slow).

One deliberate difference: ``miden_tpu``'s KeccakVarAir and SpongeAir count
the arbitrary-length keccak claims as n_claims − n_u256 − n_kmerge, without
the EC claims (public 7), so a session mixing EC and arbitrary-length keccak
claims fails their ``act/claim_count`` constraint there. The port subtracts
n_ec; the two agree whenever n_ec = 0.
"""

import numpy as np
import pytest

from miden_tpu.dsa.ecdsa_k256 import _point_mul
from miden_tpu.field import gl as j_gl
from miden_tpu.precompile import ec as j_ec
from miden_tpu.precompile import keccak as j_keccak
from miden_tpu.precompile import keccak_var as j_kvar
from miden_tpu.precompile import session as j_session
from miden_tpu.stark.air import Expr as JExpr
from miden_tpu.stark.air import Folder as JFolder
from miden_tpu.stark.air import ScalarBackend as JScalarBackend
from miden_tpu.stark.debug import check_air as j_check_air
from miden_tpu.vm import deferred as j_deferred
from miden_tpu.vm.constraints import aux_numeric as j_aux_numeric
from miden_tpu_torch.field import goldilocks as F
from miden_tpu_torch.precompile import ec, keccak, keccak_var, session
from miden_tpu_torch.stark.air import Expr, Folder, VectorBackend
from miden_tpu_torch.stark.debug import check_air
from miden_tpu_torch.vm import deferred

RAND = [(0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321), (12345, 67890)]
G, G2 = _point_mul(1), _point_mul(2)
NEG_G = (G[0], 2**256 - 2**32 - 977 - G[1])
INF = (0, 0)

# (kind, operands): every claim kind; the arbitrary-length keccak claims are
# the empty message (1 block) and 200 bytes (2 blocks, pad mid-block) at
# cycles 0 and 1-2, as in miden_tpu's tests/test_keccak_var.py
MIXED_SPEC = [
    ("u256_add", (1 << 255) + 12345, (1 << 255) + (7 << 128)),
    ("u256_mul", 0xDEADBEEF_CAFEBABE, (1 << 200) + 17),
    ("kmerge", 0x1122_DEAD_BEEF, (1 << 255) | 0xF00D),
    ("keccak", b""),
    ("ec_add", G, G2),
    ("keccak", bytes(range(200))),
    ("ec_mul", 0b1011_0110_1001, G),
]
CLAIM_SPECS = {
    "u256_add": ("u256_add", (1 << 256) - 1, 1),
    "u256_mul": ("u256_mul", (1 << 256) - 1, (1 << 256) - 1),
    "kmerge": ("kmerge", (1 << 256) - 1, 0),
    "keccak_empty": ("keccak", b""),
    "keccak_136": ("keccak", bytes(136)),
    "keccak_1k": ("keccak", bytes(range(256)) * 4),
    "ec_add_chord": ("ec_add", G, G2),
    "ec_add_negation": ("ec_add", G, NEG_G),
    "ec_add_infinity": ("ec_add", INF, G2),
    "ec_mul": ("ec_mul", 123456789, G),
}


def make_claim(spec, port: bool):
    s, k, kv, e = (session, keccak, keccak_var, ec) if port else (j_session, j_keccak, j_kvar, j_ec)
    kind, *args = spec
    cls = {
        "u256_add": s.U256AddClaim, "u256_mul": s.U256MulClaim, "kmerge": k.Keccak256Claim,
        "ec_add": e.EcAddClaim, "ec_mul": e.EcMulClaim,
    }.get(kind)
    if kind == "keccak":
        return kv.KeccakClaim(message=args[0])
    return cls(a=args[0], b=args[1])


def claim_counts(claims):
    n = len(claims)
    nu = sum(1 for c in claims if isinstance(c, (session.U256AddClaim, session.U256MulClaim)))
    nk = sum(1 for c in claims if isinstance(c, keccak.Keccak256Claim))
    nec = sum(1 for c in claims if isinstance(c, (ec.EcAddClaim, ec.EcMulClaim)))
    return n, nu, nk, nec


AIRS = {  # name -> (port AIR class, miden_tpu AIR class, SessionTraces field, bus columns fn name)
    "chain": (session.ChainAir, j_session.ChainAir, "chain", "chain_bus_columns"),
    "u256": (session.U256Air, j_session.U256Air, "u256", "u256_bus_columns"),
    "range": (session.RangeTableAir, j_session.RangeTableAir, "rng", "range_bus_columns"),
    "perm": (session.SessionPermAir, j_session.SessionPermAir, "perm", None),
    "keccak": (keccak.KeccakAir, j_keccak.KeccakAir, "keccak", "keccak_bus_columns"),
    "keccak_var": (keccak_var.KeccakVarAir, j_kvar.KeccakVarAir, "kvar", "keccak_var_bus_columns"),
    "sponge": (keccak_var.SpongeAir, j_kvar.SpongeAir, "sponge", "sponge_bus_columns"),
    "ec_op": (ec.EcOpAir, j_ec.EcOpAir, "ec_op", "ec_bus_columns"),
    "ec_mac": (ec.EcMacAir, j_ec.EcMacAir, "ec_mac", "mac_bus_columns"),
}
_CACHE: dict = {}


def mixed():
    """Port claims, port traces, publics, and the port's aux of every AIR."""
    if "mixed" not in _CACHE:
        claims = [make_claim(s, True) for s in MIXED_SPEC]
        tr = session.build_session_traces(claims)
        n, nu, nk, nec = claim_counts(claims)
        publics = [*[int(v) % j_gl.P for v in tr.root], n, nu, nk, nec]
        _CACHE["mixed"] = (claims, tr, publics, {})
    return _CACHE["mixed"]


def port_aux(name, main=None, publics=None):
    """(aux (n, 1+k, 2) u64, aux values) of the port's AIR from its torch
    builder on CPU tensors; the untampered ones are cached."""
    claims, tr, pubs, cache = mixed()
    cached = main is None and publics is None
    if cached and name in cache:
        return cache[name]
    air_cls, _, field, _ = AIRS[name]
    main = getattr(tr, field) if main is None else main
    rand = [F.ext_const(r, device="cpu") for r in RAND]
    aux, vals = air_cls().build_aux_trace(F.to_torch(main, "cpu"), publics or pubs, [], rand)
    out = (F.to_numpy(aux).reshape(main.shape[0], -1, 2), [tuple(int(x) for x in v) for v in F.to_numpy(vals)])
    if cached:
        cache[name] = out
    return out


def balance(replaced=None):
    """The cross-AIR LogUp total with AIR ``replaced[0]``'s aux values
    swapped for ``replaced[1]``."""
    finals = []
    for name in AIRS:
        vals = replaced[1] if replaced and replaced[0] == name else port_aux(name)[1]
        finals.extend(vals)
    return tuple(session.SessionMultiAir([]).eval_external(RAND, [finals], [])[0])


# ---------------------------------------------------------------------------
# Claims, digests, traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CLAIM_SPECS))
def test_claim_digest_and_root_equal_miden_tpu(kind):
    port, ref = make_claim(CLAIM_SPECS[kind], True), make_claim(CLAIM_SPECS[kind], False)
    assert port.id == ref.id and port.out == ref.out
    assert session.claim_statement_digest(port) == j_session.claim_statement_digest(ref)
    assert session.deferred_root_for([port, port]) == j_session.deferred_root_for([ref, ref])
    assert session.fold_deferred_root((1, 2, 3, 4), (5, 6, 7, 8)) == j_session.fold_deferred_root(
        (1, 2, 3, 4), (5, 6, 7, 8)
    )


def test_mixed_root_covers_every_claim_kind_and_order():
    port = [make_claim(s, True) for s in MIXED_SPEC]
    ref = [make_claim(s, False) for s in MIXED_SPEC]
    assert session.deferred_root_for(port) == j_session.deferred_root_for(ref)
    assert session.deferred_root_for(port[::-1]) == j_session.deferred_root_for(ref[::-1])
    assert session.deferred_root_for(port[::-1]) != session.deferred_root_for(port)


@pytest.mark.parametrize(
    "field", ["chain", "u256", "rng", "perm", "root", "keccak", "kvar", "sponge", "ec_op", "ec_mac"]
)
def test_session_traces_equal_miden_tpu(field):
    _, tr, _, _ = mixed()
    if "ref_traces" not in _CACHE:
        _CACHE["ref_traces"] = j_session.build_session_traces([make_claim(s, False) for s in MIXED_SPEC])
    want, got = getattr(_CACHE["ref_traces"], field), getattr(tr, field)
    if field == "root":
        assert got == want
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).all(), np.argwhere(got != want)[:5]


def _hand_built_state(d, port):
    """A DeferredState logging every claim of MIXED_SPEC, registered by hand
    (as miden_tpu's tests/test_keccak_var.py does)."""
    from miden_tpu_torch.hash.keccak_host import keccak256

    st = d.DeferredState(d.default_registry())
    for spec in MIXED_SPEC:
        cl = make_claim(spec, port)
        if spec[0] == "keccak":
            out_node = d.Node.chunks_from_bytes(keccak256(cl.message))
            st.register(out_node)
            msg_node, stmt = d.keccak_statement_node(cl.message, out_node.digest())
            st.register(msg_node)
        else:
            if spec[0] == "ec_add":
                nodes = [d.ec_point_node(*p) for p in (cl.a, cl.b, cl.out)]
            elif spec[0] == "ec_mul":
                nodes = [d.u256_value_node(cl.a), d.ec_point_node(*cl.b), d.ec_point_node(*cl.out)]
            else:
                nodes = [d.u256_value_node(x) for x in (cl.a, cl.b, cl.out)]
            for nd in nodes:
                st.register(nd)
            stmt = d.binop_statement_node(cl.id, *(nd.digest() for nd in nodes))
        st.log_statement(st.register(stmt))
    return st


def test_claims_from_deferred_state_equal_miden_tpu():
    st, j_st = _hand_built_state(deferred, True), _hand_built_state(j_deferred, False)
    assert st.root == j_st.root
    claims = session.claims_from_deferred_state(st)
    ref = j_session.claims_from_deferred_state(j_st)
    assert [type(c).__name__ for c in claims] == [type(c).__name__ for c in ref]
    assert [(c.id, c.out) for c in claims] == [(c.id, c.out) for c in ref]
    assert session.deferred_root_for(claims) == tuple(st.root)


# ---------------------------------------------------------------------------
# Constraints: check_air, LogUp balance, aux builder, constraint fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(AIRS))
def test_check_air_accepts_every_session_air(name):
    _, tr, publics, _ = mixed()
    air_cls, _, field, _ = AIRS[name]
    aux, vals = port_aux(name)
    vs = check_air(air_cls(), getattr(tr, field), aux=aux, publics=publics, randomness=RAND, aux_values=vals)
    assert not vs, vs[:4]


def test_logup_total_is_zero():
    assert balance() == (0, 0)


def test_miden_tpu_rejects_an_ec_and_keccak_session():
    """The one place the port's session AIRs differ from miden_tpu's (module
    docstring): miden_tpu's KeccakVarAir flags act/claim_count on a session
    with an EC claim and a keccak claim; the port's accepts such a session
    (test_check_air_accepts_every_session_air: MIXED_SPEC has both)."""
    claims = [make_claim(("keccak", b""), True), make_claim(("ec_add", G, G2), True)]
    kvar = session.build_session_traces(claims).kvar  # one claim: 2 cycles, 64 rows
    publics = [0, 0, 0, 0, 2, 0, 0, 1]
    aux, vals = j_aux_numeric.build_numeric_aux(
        j_kvar.KeccakVarAir(), kvar, publics, RAND, j_kvar.keccak_var_bus_columns
    )
    air = j_kvar.KeccakVarAir()
    vs = j_check_air(air, kvar, aux=aux, publics=publics, randomness=RAND, aux_values=vals, max_violations=1)
    assert [(v.row, air.label_order[v.index]) for v in vs] == [(31, "act/claim_count")]


@pytest.mark.parametrize("name", list(AIRS))
def test_torch_aux_builder_equals_miden_tpu_numeric(name):
    """The port's build_device_aux ≡ miden_tpu's build_numeric_aux. EcMacAir
    has 49 fraction columns under 65 β-powers, the widest batch inverse."""
    _, tr, publics, _ = mixed()
    _, j_cls, field, cols = AIRS[name]
    main = getattr(tr, field)
    got, got_vals = port_aux(name)
    if name == "range":
        # miden_tpu's per-row builder takes 15 s over the 2^17 rows; the
        # first 2^12 (active rows with their multiplicities) hold the port's
        # builder to it, the full table's balance is test_logup_total_is_zero
        main = main[: 1 << 12]
        got, got_vals = port_aux(name, main=main)
    if cols is None:  # the Poseidon2 permutation AIR of the VM
        want, want_vals = j_cls().build_aux_trace(main, publics, [], RAND)
    else:
        mod = {"chain": j_session, "u256": j_session, "range": j_session, "keccak": j_keccak,
               "keccak_var": j_kvar, "sponge": j_kvar, "ec_op": j_ec, "ec_mac": j_ec}[name]
        want, want_vals = j_aux_numeric.build_numeric_aux(j_cls(), main, publics, RAND, getattr(mod, cols))
    assert got.shape == want.shape == (main.shape[0], j_cls.aux_width, 2)
    assert (got == want).all(), np.argwhere(got != want)[:5]
    assert got_vals == [tuple(int(x) for x in v) for v in want_vals]


def _vector_fold(air, pts, publics, alpha):
    """The port's α-folded constraints over the k points of ``pts``."""
    be = VectorBackend((pts["k"],), "cpu")

    def t(a):
        return F.to_torch(np.asarray(a, dtype=np.uint64), "cpu")

    folder = Folder(
        be,
        main_fn=lambda c, o=0: Expr(be, "base", t(pts["main"][o][:, c])),
        aux_fn=lambda c, o=0: Expr(be, "ext", t(pts["aux"][o][:, c])),
        periodic=[Expr(be, "base", t(pts["periodic"][:, i])) for i in range(len(air.periodic_columns))],
        publics=[Expr(be, "base", be.const(v)) for v in publics],
        randomness=[Expr(be, "ext", F.ext_const(r, device="cpu")) for r in RAND],
        aux_values=[Expr(be, "ext", F.ext_const(pts["aux_value"], device="cpu"))],
        selectors=tuple(Expr(be, "base", t(pts["sel"][:, i])) for i in range(3)),
        alpha=Expr(be, "ext", F.ext_const(alpha, device="cpu")),
    )
    air.eval(folder)
    return [tuple(int(x) for x in v) for v in F.to_numpy(folder.acc.val)]


def _scalar_fold(air, pts, j, publics, alpha):
    """miden_tpu's α-folded constraints at point j, exact Python ints."""
    be = JScalarBackend()
    folder = JFolder(
        be,
        main_fn=lambda c, o=0: JExpr(be, "base", int(pts["main"][o][j, c])),
        aux_fn=lambda c, o=0: JExpr(be, "ext", tuple(int(x) for x in pts["aux"][o][j, c])),
        periodic=[JExpr(be, "base", int(v)) for v in pts["periodic"][j]],
        publics=[JExpr(be, "base", v % j_gl.P) for v in publics],
        randomness=[JExpr(be, "ext", r) for r in RAND],
        aux_values=[JExpr(be, "ext", pts["aux_value"])],
        selectors=tuple(JExpr(be, "base", int(v)) for v in pts["sel"][j]),
        alpha=JExpr(be, "ext", alpha),
    )
    air.eval(folder)
    return folder.acc.val


@pytest.mark.parametrize("name", list(AIRS))
def test_vector_fold_equals_miden_tpu_scalar_fold(name):
    """At 3 seeded random points (main, aux, periodic values, selectors,
    publics, α all random), the port's torch fold of every constraint
    equals miden_tpu's exact scalar fold — the constraint polynomials are
    the same. n_ec (public 7) is 0 here, where the two packages agree."""
    air_cls, j_cls, _, _ = AIRS[name]
    pts, publics, alpha = _random_points(air_cls(), sum(map(ord, name)))
    publics[7] = 0
    got = _vector_fold(air_cls(), pts, publics, alpha)
    want = [_scalar_fold(j_cls(), pts, j, publics, alpha) for j in range(pts["k"])]
    assert got == [tuple(v) for v in want]


def _random_points(air, seed):
    """3 random points of ``air`` (main and aux rows with their next rows,
    periodic values, selectors, an aux value), 8 random publics and α."""
    rng = np.random.default_rng(seed)
    k, w = 3, air.width
    pts = {
        "k": k,
        "main": [rng.integers(0, j_gl.P, size=(k, w), dtype=np.uint64) for _ in range(2)],
        "aux": [rng.integers(0, j_gl.P, size=(k, air.aux_width, 2), dtype=np.uint64) for _ in range(2)],
        "periodic": rng.integers(0, j_gl.P, size=(k, len(air.periodic_columns)), dtype=np.uint64),
        "sel": rng.integers(0, j_gl.P, size=(k, 3), dtype=np.uint64),
        "aux_value": tuple(int(x) for x in rng.integers(0, j_gl.P, size=2, dtype=np.uint64)),
    }
    publics = [int(x) for x in rng.integers(0, j_gl.P, size=8, dtype=np.uint64)]
    alpha = tuple(int(x) for x in rng.integers(0, j_gl.P, size=2, dtype=np.uint64))
    return pts, publics, alpha


@pytest.mark.parametrize("name", ["keccak_var", "sponge"])
def test_claim_count_with_ec_claims_equals_miden_tpu_with_the_count_moved(name):
    """The port's act/claim_count with n_ec (public 7) ≠ 0, against an
    evaluation independent of the port: miden_tpu's scalar fold at publics
    that give its n_claims − n_u256 − n_kmerge the port's n_arb. KeccakVarAir
    reads publics 4–6 only there, so n_claims moves by −n_ec. SpongeAir also
    reads n_claims + n_u256 + n_kmerge (its permutation count), so half of
    n_ec moves off n_claims and half onto n_u256, keeping that sum."""
    air_cls, j_cls, _, _ = AIRS[name]
    pts, publics, alpha = _random_points(air_cls(), 7 + len(name))
    n_ec = publics[7]
    moved = list(publics)
    if name == "keccak_var":
        moved[4] = (publics[4] - n_ec) % j_gl.P
    else:
        half = j_gl.mul(n_ec, j_gl.inv(2))
        moved[4] = (publics[4] - half) % j_gl.P
        moved[5] = (publics[5] + half) % j_gl.P
    got = _vector_fold(air_cls(), pts, publics, alpha)
    want = [_scalar_fold(j_cls(), pts, j, moved, alpha) for j in range(pts["k"])]
    assert got == [tuple(v) for v in want]
    # and the fault it repairs: miden_tpu at the same publics differs
    assert got != [tuple(_scalar_fold(j_cls(), pts, j, publics, alpha)) for j in range(pts["k"])]


# ---------------------------------------------------------------------------
# Tampering: the cases of miden_tpu's precompile tests, on the port
# ---------------------------------------------------------------------------


def _flip(field, row, col, value=None):
    def mutate(tr):
        m = getattr(tr, field).copy()
        m[row, col] = (1 - int(m[row, col])) if value is None else value(int(m[row, col]))
        return field, m

    return mutate


TAMPER = {
    # tests/test_precompile.py: an output limb of the add row; a mul row's
    # output limb and carry-hi (constraint or range-bus imbalance)
    "u256_add_output": ("u256", _flip("u256", 0, session.U_O[3], lambda v: v ^ 1)),
    "u256_mul_output": ("u256", _flip("u256", 1, session.U_O[7], lambda v: (v + 1) % j_gl.P)),
    "u256_mul_carry_hi": ("u256", _flip("u256", 1, session.U_CH[3], lambda v: (v + 40) % j_gl.P)),
    # tests/test_precompile_keccak.py: a mid-round state bit, non-boolean junk
    "keccak_round_bit": ("keccak", _flip("keccak", 5, keccak.K_A0 + 77), ("round/", "theta/")),
    "keccak_non_boolean": ("keccak", _flip("keccak", keccak.CYCLE - 2, keccak.K_A0 + 3, lambda v: 7), ("bool/",)),
    # tests/test_keccak_var.py:127-142: digest bit on the final out row,
    # message bit, the sponge's length
    "keccak_var_digest_bit": ("keccak_var", _flip("kvar", keccak_var.CYCLE * 2 + 24, keccak_var.V_A0 + 3)),
    "keccak_var_message_bit": ("keccak_var", _flip("kvar", keccak_var.CYCLE, keccak_var.V_A0 + 7)),
    "sponge_length": ("sponge", _flip("sponge", 0, keccak_var.S_LEN, lambda v: v + 1)),
    # tests/test_ec_precompile.py: the add claim's result limb
    "ec_result_limb": ("ec_op", _flip("ec_op", 0, ec.E_XR[0], lambda v: v ^ 1)),
}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_tampered_session_rejected(case):
    name, mutate, *labels = TAMPER[case]
    _, tr, publics, _ = mixed()
    field, bad = mutate(tr)
    aux, vals = port_aux(name, main=bad)
    if not labels and balance((name, vals)) != (0, 0):
        return  # the cross-AIR LogUp total rejects it
    air = AIRS[name][0]()
    vs = check_air(air, bad, aux=aux, publics=publics, randomness=RAND, aux_values=vals, max_violations=1)
    assert vs, f"{case}: tampered session accepted"
    if labels:  # the constraint family miden_tpu's test names fires
        assert any(air.label_order[v.index].startswith(labels[0]) for v in vs), vs[:3]


@pytest.mark.parametrize("cap", [1, 20, 1000])
def test_check_air_on_repeated_rows_equals_miden_tpu(cap):
    """The port's check_air evaluates a repeated row window once and copies
    its violations. On a chain trace whose rows are all one tampered row
    (every window but the first and last repeats), its violation list
    equals miden_tpu's, which evaluates every row, at every cap. Both stop
    at the first row that reaches ``max_violations``, so a list may run past
    the cap by that row's violations (cap 20: 21)."""
    _, tr, publics, _ = mixed()
    bad = np.repeat(tr.chain[:1], tr.chain.shape[0], axis=0)
    bad[:, 3] += 1
    aux, vals = port_aux("chain", main=bad)
    got, want = (
        [(v.row, v.index, v.value) for v in check(air, bad, aux=aux, publics=publics, randomness=RAND,
                                                   aux_values=vals, max_violations=cap)]
        for check, air in ((check_air, session.ChainAir()), (j_check_air, j_session.ChainAir()))
    )
    assert got == want and got


def test_wrong_public_root_fires_the_root_binding():
    """tests/test_precompile.py: a wrong root in the publics."""
    _, tr, publics, _ = mixed()
    bad = [publics[0] ^ 1, *publics[1:]]
    aux, vals = port_aux("chain", publics=bad)
    air = session.ChainAir()
    vs = check_air(air, tr.chain, aux=aux, publics=bad, randomness=RAND, aux_values=vals)
    assert any("root" in air.label_order[v.index] for v in vs if v.index < len(air.label_order)), vs[:3]


# ---------------------------------------------------------------------------
# The stdlib subset
# ---------------------------------------------------------------------------


def _limbs256(x):
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _store8(x, addr):
    v = _limbs256(x)
    return (
        f"push.{v[3]}.{v[2]}.{v[1]}.{v[0]} push.{addr} mem_storew_le dropw "
        f"push.{v[7]}.{v[6]}.{v[5]}.{v[4]} push.{addr + 4} mem_storew_le dropw "
    )


def ecdsa_source(seed: bytes, base: int = 100) -> str:
    """One in-VM ECDSA verification (tests/test_ec_precompile.py:401-418)."""
    from miden_tpu_torch.dsa.ecdsa_k256 import SigningKey

    sk = SigningKey.from_seed(seed)
    pk = sk.public_key()
    digest = bytes(range(32))
    sig = sk.sign_prehash(digest)
    vals = (int.from_bytes(digest, "big"), sig.r, sig.s, pk.x, pk.y)
    body = "".join(_store8(v, base + 8 * j) for j, v in enumerate(vals))
    return (
        "use miden::core::crypto::dsa::ecdsa_secp256k1\n"
        f"begin {body}push.{base} exec.ecdsa_secp256k1::verify_prehash end"
    )


def hash_memory_source(message: bytes) -> str:
    """tests/test_keccak_var.py:204-217."""
    limbs = [v for c in deferred.keccak_message_chunks(message) for v in c]
    stores = "".join(f"push.{v}.{1000 + i} mem_store " for i, v in enumerate(limbs) if v)
    return (
        "use miden::core::crypto::hashes::keccak256\n"
        f"begin {stores} push.{len(message)} push.1000 exec.keccak256::hash_memory end"
    )


STDLIB_PROGRAMS = {
    "ecdsa": lambda: ecdsa_source(b"miden-tpu-ecdsa-test"),
    "hash_memory": lambda: hash_memory_source(bytes(range(1, 201))),
    "merge": lambda: (
        "use miden::core::crypto::hashes::keccak256\n"
        "begin push.1.2.3.4.5.6.7.8 push.9.10.11.12.13.14.15.16 exec.keccak256::merge end"
    ),
    "ec_add_mul": lambda: (
        "use miden::core::crypto::ec::secp256k1\n"
        "begin exec.secp256k1::add dropw dropw dropw dropw exec.secp256k1::mul end"
    ),
    "u256": lambda: (
        "use miden::core::math::u256\n"
        "begin push.1.2.3.4.5.6.7.8 push.1.2.3.4.5.6.7.8 exec.u256::eq end"
    ),
}


#: the port's MAST digest of STDLIB_PROGRAMS["ecdsa"]: its verify_prehash
#: takes the x(R') == r + n branch only where r + n does not carry out of 256
#: bits and is below p, so the procedure (and the program) differ from
#: miden_tpu's, whose wrapping add accepts forged signatures
ECDSA_PROGRAM_DIGEST = (
    12022394599022275205, 8542477626805261521, 14325601141032899070, 5888747325389681874,
)


@pytest.mark.parametrize("name", sorted(STDLIB_PROGRAMS))
def test_stdlib_mast_digest_equals_miden_tpu(name):
    from miden_tpu.stdlib import assemble_with_stdlib as j_assemble
    from miden_tpu_torch.stdlib import assemble_with_stdlib

    src = STDLIB_PROGRAMS[name]()
    if name == "ecdsa":  # the repaired verify_prehash
        assert tuple(assemble_with_stdlib(src).hash) == ECDSA_PROGRAM_DIGEST != tuple(j_assemble(src).hash)
    else:
        assert assemble_with_stdlib(src).hash == j_assemble(src).hash


def forged_ecdsa_vector(t: int = 0x1234567, s: int = 0x55, e: int = 0x77) -> tuple:
    """(e, r, s, Q) that only a wrapping r + n accepts: R = [t]G with
    r = x(R) + (2^256 - n) < n, and Q = [(s·t − e)/r mod n]G, so the
    commitment point [e/s]G + [r/s]Q is R and x(R) = r + n − 2^256."""
    from miden_tpu_torch.dsa.ecdsa_k256 import N, _point_mul

    while True:
        r = _point_mul(t)[0] + (2**256 - N)
        if r < N:
            break
        t += 1
    q = (s * t - e) * pow(r, -1, N) % N
    return e, r, s, _point_mul(q)


def ecdsa_values_source(e: int, r: int, s: int, q: tuple, base: int = 100) -> str:
    body = "".join(_store8(v, base + 8 * j) for j, v in enumerate((e, r, s, *q)))
    return (
        "use miden::core::crypto::dsa::ecdsa_secp256k1\n"
        f"begin {body}push.{base} exec.ecdsa_secp256k1::verify_prehash end"
    )


def test_forged_ecdsa_signature_is_rejected_in_the_vm_and_on_the_host():
    """The port's in-VM verifier and its host verifier both reject the
    forged vector; miden_tpu's in-VM verifier accepts it (pinned: this
    fails once miden_tpu is repaired). Honest signatures still verify.
    The legitimate x(R') ≥ n branch (x(R') = r + n < p) has no findable
    vector: it needs x(R') in [n, p), a chance of about 2^-127."""
    from miden_tpu.stdlib import assemble_with_stdlib as j_assemble
    from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
    from miden_tpu.vm.processor import execute as j_execute
    from miden_tpu_torch.dsa.ecdsa_k256 import PublicKey, Signature, is_on_curve
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm.processor import execute

    e, r, s, q = forged_ecdsa_vector()
    assert is_on_curve(q)
    assert not PublicKey(*q).verify_prehash(e.to_bytes(32, "big"), Signature(r, s, 0))
    src = ecdsa_values_source(e, r, s, q)
    assert execute(assemble_with_stdlib(src), [], event_handlers=stdlib_event_handlers()).stack[0] == 0
    assert j_execute(j_assemble(src), [], event_handlers=j_handlers()).stack[0] == 1
    honest = ecdsa_source(b"miden-tpu-ecdsa-forgery-test")
    assert execute(assemble_with_stdlib(honest), [], event_handlers=stdlib_event_handlers()).stack[0] == 1


def test_stdlib_handlers_and_modules_equal_miden_tpu():
    from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
    from miden_tpu.stdlib import stdlib_modules as j_modules
    from miden_tpu_torch.stdlib import stdlib_event_handlers, stdlib_modules

    handlers, theirs = stdlib_event_handlers(), j_handlers()
    assert set(handlers) == set(theirs)
    assert {k: h.__name__ for k, h in handlers.items()} == {k: h.__name__ for k, h in theirs.items()}
    # all 25 of miden_tpu's modules, the seven of the in-VM STARK verifier included
    assert len(j_modules()) == 25
    assert sorted(stdlib_modules()) == sorted(j_modules()) == [
        "miden::core::collections::mmr", "miden::core::collections::smt",
        "miden::core::collections::sorted_array", "miden::core::crypto::aead",
        "miden::core::crypto::dsa::ecdsa_secp256k1", "miden::core::crypto::ec::secp256k1",
        "miden::core::crypto::hashes::blake3", "miden::core::crypto::hashes::keccak256",
        "miden::core::crypto::hashes::poseidon2", "miden::core::crypto::hashes::sha256",
        "miden::core::debug", "miden::core::math::bits", "miden::core::math::u128",
        "miden::core::math::u256", "miden::core::math::u64", "miden::core::mem",
        "miden::core::pcs::fri::frie2f4", "miden::core::stark::constants",
        "miden::core::stark::deep_queries", "miden::core::stark::ood_frames",
        "miden::core::stark::public_inputs", "miden::core::stark::random_coin",
        "miden::core::sys", "miden::core::sys::vm::constraints_eval", "miden::core::word",
    ]


@pytest.mark.parametrize("name", ["ecdsa", "hash_memory"])
def test_stdlib_deferred_state_equals_miden_tpu(name):
    """The same program on both packages logs the same deferred DAG: root,
    wire bytes and the session claims the bridge extracts."""
    from miden_tpu.stdlib import assemble_with_stdlib as j_assemble
    from miden_tpu.stdlib import stdlib_event_handlers as j_handlers
    from miden_tpu.vm.processor import execute as j_execute
    from miden_tpu_torch.stdlib import assemble_with_stdlib, stdlib_event_handlers
    from miden_tpu_torch.vm.processor import execute

    src = STDLIB_PROGRAMS[name]()
    out = execute(assemble_with_stdlib(src), [], event_handlers=stdlib_event_handlers())
    ref = j_execute(j_assemble(src), [], event_handlers=j_handlers())
    assert list(out.stack) == list(ref.stack)
    if name == "ecdsa":
        assert int(out.stack[0]) == 1  # the signature verifies in the VM
    assert tuple(out.deferred_root) == tuple(ref.deferred_root) != (0, 0, 0, 0)
    assert out.deferred_state.to_wire().to_bytes() == ref.deferred_state.to_wire().to_bytes()
    claims = session.claims_from_deferred_state(out.deferred_state)
    want = j_session.claims_from_deferred_state(ref.deferred_state)
    assert [(type(c).__name__, c.id, c.out) for c in claims] == [(type(c).__name__, c.id, c.out) for c in want]
    assert session.deferred_root_for(claims) == tuple(out.deferred_root)


# ---------------------------------------------------------------------------
# VM facade: check_core_trace, verify_program(deferred=...)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tamper", [False, True])
def test_check_core_trace_agrees_with_miden_tpu(tamper):
    from miden_tpu.vm import assemble as j_assemble
    from miden_tpu.vm.constraints import check_core_trace as j_check_core_trace
    from miden_tpu.vm.trace import execute_and_trace as j_execute_and_trace
    from miden_tpu_torch.vm import assemble
    from miden_tpu_torch.vm.constraints import check_core_trace
    from miden_tpu_torch.vm.trace import execute_and_trace

    src = "begin push.0 push.1 repeat.6 swap dup.1 add end swap drop swap drop end"
    _, trace = execute_and_trace(assemble(src))
    _, j_trace = j_execute_and_trace(j_assemble(src))
    if tamper:  # a stack cell mid-program
        for t in (trace, j_trace):
            t.matrix = np.array(t.matrix, dtype=np.uint64)
            t.matrix[9, 30] = (int(t.matrix[9, 30]) + 1) % j_gl.P
    got = [(v.row, v.index, v.label, v.value) for v in check_core_trace(trace)]
    want = [(v.row, v.index, v.label, v.value) for v in j_check_core_trace(j_trace)]
    assert got == want
    assert bool(got) == tamper


def test_verify_program_checks_the_session_root():
    """A session whose root is not the bound one is a VerificationError
    (verify_deferred's first check), not NotImplementedError."""
    from miden_tpu_torch.stark.verifier import VerificationError
    from miden_tpu_torch.vm.prove import VmProof, verify_program

    proof = VmProof(
        program_hash=(1, 2, 3, 4), stack_inputs=[0] * 16, stack_outputs=[0] * 16,
        kernel_digests=(), stark=None, deferred_root=(5, 6, 7, 8),
    )
    wrong = session.DeferredProof(root=(5, 6, 7, 9), n_claims=1, stark=None)
    with pytest.raises(VerificationError, match="deferred root mismatch"):
        verify_program(proof, deferred=wrong)
    with pytest.raises(VerificationError, match="supply the deferred"):
        verify_program(proof)
