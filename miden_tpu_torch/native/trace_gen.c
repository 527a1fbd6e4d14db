/* Native basic-block interpreter + core-trace emitter.
 *
 * Host-side counterpart of the reference's fast-processor + parallel
 * trace build (processor/src/fast/mod.rs:102 interpreter at ~320 MHz,
 * processor/src/trace/parallel/mod.rs:91 build_trace): the Python
 * interpreter (miden_tpu_torch/vm/processor.py) tops out around 10^5 rows/s,
 * which caps provable programs at toy sizes; this C twin executes the
 * hot op subset and writes 51-column core-trace rows straight into a
 * caller-provided (numpy) uint64 buffer at ~10^8 rows/s.
 *
 * Semantics are an exact port of miden_tpu_torch/vm/{processor,trace}.py for
 * the supported subset (field/u32/stack ops inside one basic block);
 * equivalence is pinned by tests/test_native_trace.py (for the copy in
 * miden_tpu) and tests/test_torch_vm_host.py, which compare whole trace
 * matrices against the Python builder and the JAX package.
 *
 * Build (native/__init__.py, at first use):
 *   cc -O2 -shared -fPIC -o miden_tpu_torch/_build/libtrace_gen.so trace_gen.c
 */

#include <stdint.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef int64_t i64;

static const u64 PGL = 0xFFFFFFFF00000001ULL; /* Goldilocks prime */
static const u64 U32MAX = 0xFFFFFFFFULL;

static inline u64 gl_add(u64 a, u64 b) {
    u64 r = a + b;
    /* a, b < p < 2^64; overflow or r >= p -> subtract p */
    if (r < a || r >= PGL) r -= PGL;
    return r;
}

static inline u64 gl_sub(u64 a, u64 b) {
    return a >= b ? a - b : a + PGL - b;
}

static inline u64 gl_mul(u64 a, u64 b) {
    u128 x = (u128)a * b;
    u64 lo = (u64)x, hi = (u64)(x >> 64);
    /* reduce128: hi = n2*2^96 + n1*2^64 with n2 = hi>>32, n1 = hi&mask;
       2^64 = 2^32 - 1, 2^96 = -1 (mod p) */
    u64 n2 = hi >> 32, n1 = hi & U32MAX;
    u64 t = lo >= n2 ? lo - n2 : lo - n2 + PGL; /* lo - n2 mod p (n2 < 2^32) */
    u64 t1 = (n1 << 32) - n1;                   /* n1 * (2^32 - 1) < p */
    u64 r = t + t1;
    if (r < t || r >= PGL) r -= PGL;
    return r;
}

static inline u64 gl_pow(u64 a, u64 e) {
    u64 r = 1;
    while (e) {
        if (e & 1) r = gl_mul(r, a);
        a = gl_mul(a, a);
        e >>= 1;
    }
    return r;
}

static inline u64 gl_inv(u64 a) { return a ? gl_pow(a, PGL - 2) : 0; }

/* ---- column layout (miden_tpu_torch/vm/layout.py) ---- */
#define COL_CLK 0
#define COL_CTX 1
#define COL_FN 2 /* ..5 */
#define COL_ADDR 6
#define COL_BITS 7  /* ..13 */
#define COL_H 14    /* ..21 */
#define COL_INSPAN 22
#define COL_GC 23
#define COL_OPIDX 24
#define COL_BATCH 25 /* ..27 */
#define COL_E0 28
#define COL_E1 29
#define COL_S 30 /* ..45 */
#define COL_B0 46
#define COL_B1 47
#define W 51
#define MINDEPTH 16

/* ---- internal op enum (matches miden_tpu_torch/vm/native_trace.py) ---- */
enum {
    OP_NOOP = 0, OP_ASSERT, OP_ADD, OP_MUL, OP_NEG, OP_INV, OP_INCR,
    OP_NOT, OP_AND, OP_OR, OP_EQ, OP_EQZ, OP_EXPACC, OP_EXT2MUL,
    OP_PAD, OP_DROP, OP_SWAP, OP_SWAPW, OP_SWAPDW, OP_DUP, OP_MOVUP,
    OP_MOVDN, OP_CSWAP, OP_CSWAPW, OP_PUSH, OP_SDEPTH, OP_CLK,
    OP_U32SPLIT, OP_U32ADD, OP_U32ADD3, OP_U32SUB, OP_U32MUL,
    OP_U32MADD, OP_U32DIV, OP_U32ASSERT2,
};

/* ---- VM state ---- */
typedef struct {
    u64 *stack;     /* stack[0] = top; capacity from caller */
    u64 *ovf_clk;   /* clk stamps of overflow pushes, newest first */
    i64 depth;      /* logical depth, >= 16 */
    i64 n_ovf;      /* == depth - 16 */
    u64 clk;
    u64 ctx;        /* execution context id (column 1) */
    u64 fn_hash[4]; /* current fn hash (columns 2..5) */
} Vm;

static inline void vm_push(Vm *v, u64 val) {
    memmove(v->stack + 1, v->stack, (size_t)(v->depth) * 8);
    v->stack[0] = val;
    memmove(v->ovf_clk + 1, v->ovf_clk, (size_t)(v->n_ovf) * 8);
    v->ovf_clk[0] = v->clk;
    v->depth++;
    v->n_ovf++;
}

static inline void vm_drop(Vm *v) {
    memmove(v->stack, v->stack + 1, (size_t)(v->depth - 1) * 8);
    if (v->depth > MINDEPTH) {
        v->depth--;
        memmove(v->ovf_clk, v->ovf_clk + 1, (size_t)(v->n_ovf - 1) * 8);
        v->n_ovf--;
    } else {
        v->stack[v->depth - 1] = 0;
    }
}

static void capture(u64 *row, const Vm *v, u64 opcode, u64 addr,
                    const u64 *h, u64 in_span, u64 gc, u64 op_index,
                    const u64 *batch) {
    memset(row, 0, W * 8);
    row[COL_CLK] = v->clk;
    row[COL_CTX] = v->ctx;
    for (int i = 0; i < 4; i++) row[COL_FN + i] = v->fn_hash[i];
    row[COL_ADDR] = addr;
    u64 b5 = (opcode >> 5) & 1, b4 = (opcode >> 4) & 1, b6 = (opcode >> 6) & 1;
    for (int i = 0; i < 7; i++) row[COL_BITS + i] = (opcode >> i) & 1;
    if (h) for (int i = 0; i < 8; i++) row[COL_H + i] = h[i];
    row[COL_INSPAN] = in_span;
    row[COL_GC] = gc;
    row[COL_OPIDX] = op_index;
    if (batch) for (int i = 0; i < 3; i++) row[COL_BATCH + i] = batch[i];
    row[COL_E0] = b6 & (1 - b5) & b4;
    row[COL_E1] = b6 & b5;
    for (int i = 0; i < MINDEPTH; i++) row[COL_S + i] = v->stack[i];
    row[COL_B0] = (u64)v->depth;
    row[COL_B1] = v->n_ovf ? v->ovf_clk[0] : 0;
}

static void batch_flags(i64 num_groups, u64 *out) {
    /* BATCH_FLAGS_BY_COUNT: 8:(1,0,0) 4:(0,1,0) 2:(0,0,1) 1:(0,1,1) */
    out[0] = out[1] = out[2] = 0;
    if (num_groups == 8) out[0] = 1;
    else if (num_groups == 4) out[1] = 1;
    else if (num_groups == 2) out[2] = 1;
    else { out[1] = 1; out[2] = 1; }
}

/* Execute one op; writes helper registers into row[h2..h7]; appends range
 * checks. Returns 0 ok, negative error. */
static int exec_op(Vm *v, int kind, u64 param, u64 imm, u64 *row,
                   u64 *rc, i64 *n_rc) {
    u64 *s = v->stack;
    u64 a, b, c, lo, hi, t0, t1, t2, t3;
    switch (kind) {
    case OP_NOOP: break;
    case OP_ASSERT:
        if (s[0] != 1) return -10;
        vm_drop(v); break;
    case OP_ADD:
        a = s[0]; b = s[1]; vm_drop(v); s[0] = gl_add(a, b); break;
    case OP_MUL:
        a = s[0]; b = s[1]; vm_drop(v); s[0] = gl_mul(a, b); break;
    case OP_NEG: s[0] = s[0] ? PGL - s[0] : 0; break;
    case OP_INV:
        if (!s[0]) return -11;
        s[0] = gl_inv(s[0]); break;
    case OP_INCR: s[0] = gl_add(s[0], 1); break;
    case OP_NOT:
        if (s[0] > 1) return -12;
        s[0] ^= 1; break;
    case OP_AND:
        a = s[0]; b = s[1];
        if (a > 1 || b > 1) return -12;
        vm_drop(v); s[0] = a & b; break;
    case OP_OR:
        a = s[0]; b = s[1];
        if (a > 1 || b > 1) return -12;
        vm_drop(v); s[0] = a | b; break;
    case OP_EQ:
        a = s[0]; b = s[1]; vm_drop(v);
        s[0] = (a == b) ? 1 : 0;
        row[COL_H + 2] = gl_inv(gl_sub(a, b));
        break;
    case OP_EQZ:
        a = s[0];
        s[0] = (a == 0) ? 1 : 0;
        row[COL_H + 2] = gl_inv(a);
        break;
    case OP_EXPACC: {
        u64 base = s[1], acc = s[2], exp = s[3];
        u64 lsb = exp & 1;
        u64 upd = lsb ? base : 1;
        s[0] = lsb;
        s[1] = gl_mul(base, base);
        s[2] = gl_mul(acc, upd);
        s[3] = exp >> 1;
        row[COL_H + 2] = upd;
        break;
    }
    case OP_EXT2MUL: {
        u64 b0 = s[0], b1 = s[1], a0 = s[2], a1 = s[3];
        s[2] = gl_add(gl_mul(a0, b0), gl_mul(7, gl_mul(a1, b1)));
        s[3] = gl_add(gl_mul(a0, b1), gl_mul(a1, b0));
        break;
    }
    case OP_PAD: vm_push(v, 0); break;
    case OP_DROP: vm_drop(v); break;
    case OP_SWAP: a = s[0]; s[0] = s[1]; s[1] = a; break;
    case OP_SWAPW: {
        i64 off = (i64)param; /* 4, 8, 12 */
        for (int i = 0; i < 4; i++) { a = s[i]; s[i] = s[off + i]; s[off + i] = a; }
        break;
    }
    case OP_SWAPDW:
        for (int i = 0; i < 8; i++) { a = s[i]; s[i] = s[8 + i]; s[8 + i] = a; }
        break;
    case OP_DUP: a = s[param]; vm_push(v, a); break;
    case OP_MOVUP: {
        i64 n = (i64)param;
        a = s[n];
        memmove(s + 1, s, (size_t)n * 8);
        s[0] = a;
        break;
    }
    case OP_MOVDN: {
        i64 n = (i64)param;
        a = s[0];
        memmove(s, s + 1, (size_t)n * 8);
        s[n] = a;
        break;
    }
    case OP_CSWAP:
        c = s[0];
        if (c > 1) return -12;
        vm_drop(v);
        if (c) { a = s[0]; s[0] = s[1]; s[1] = a; }
        break;
    case OP_CSWAPW:
        c = s[0];
        if (c > 1) return -12;
        vm_drop(v);
        if (c) for (int i = 0; i < 4; i++) { a = s[i]; s[i] = s[4 + i]; s[4 + i] = a; }
        break;
    case OP_PUSH: vm_push(v, imm); break;
    case OP_SDEPTH: vm_push(v, (u64)v->depth); break;
    case OP_CLK: vm_push(v, v->clk); break;
    case OP_U32SPLIT: {
        u64 val = s[0];
        lo = val & U32MAX; hi = val >> 32;
        s[0] = hi;
        vm_push(v, lo);
        t0 = lo & 0xFFFF; t1 = lo >> 16; t2 = hi & 0xFFFF; t3 = hi >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1; rc[(*n_rc)++] = t2; rc[(*n_rc)++] = t3;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1; row[COL_H + 4] = t2;
        row[COL_H + 5] = t3; row[COL_H + 6] = gl_inv(gl_sub(U32MAX, hi));
        break;
    }
    case OP_U32ADD: case OP_U32MUL: {
        a = s[0]; b = s[1];
        if (a > U32MAX || b > U32MAX) return -13;
        u64 r = (kind == OP_U32ADD) ? a + b : a * b;
        lo = r & U32MAX; hi = r >> 32;
        s[0] = lo; s[1] = hi;
        t0 = lo & 0xFFFF; t1 = lo >> 16; t2 = hi & 0xFFFF; t3 = hi >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1; rc[(*n_rc)++] = t2; rc[(*n_rc)++] = t3;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1; row[COL_H + 4] = t2; row[COL_H + 5] = t3;
        if (kind == OP_U32MUL) row[COL_H + 6] = gl_inv(gl_sub(U32MAX, hi));
        break;
    }
    case OP_U32ADD3: case OP_U32MADD: {
        a = s[0]; b = s[1]; c = s[2];
        if (a > U32MAX || b > U32MAX || c > U32MAX) return -13;
        u64 r = (kind == OP_U32ADD3) ? a + b + c : a * b + c;
        vm_drop(v);
        s[0] = r & U32MAX; s[1] = r >> 32;
        lo = s[0]; hi = s[1];
        t0 = lo & 0xFFFF; t1 = lo >> 16; t2 = hi & 0xFFFF; t3 = hi >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1; rc[(*n_rc)++] = t2; rc[(*n_rc)++] = t3;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1; row[COL_H + 4] = t2; row[COL_H + 5] = t3;
        if (kind == OP_U32MADD) row[COL_H + 6] = gl_inv(gl_sub(U32MAX, hi));
        break;
    }
    case OP_U32SUB: {
        b = s[0]; a = s[1];
        if (a > U32MAX || b > U32MAX) return -13;
        u64 diff = (a - b) & U32MAX;
        u64 borrow = a < b ? 1 : 0;
        s[0] = borrow; s[1] = diff;
        t0 = diff & 0xFFFF; t1 = diff >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1;
        break;
    }
    case OP_U32DIV: {
        b = s[0]; a = s[1];
        if (a > U32MAX || b > U32MAX) return -13;
        if (!b) return -11;
        u64 q = a / b, r = a % b;
        s[0] = r; s[1] = q;
        lo = a - q; hi = b - r - 1;
        t0 = lo & 0xFFFF; t1 = lo >> 16; t2 = hi & 0xFFFF; t3 = hi >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1; rc[(*n_rc)++] = t2; rc[(*n_rc)++] = t3;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1; row[COL_H + 4] = t2; row[COL_H + 5] = t3;
        break;
    }
    case OP_U32ASSERT2: {
        a = s[0]; b = s[1];
        if (a > U32MAX || b > U32MAX) return -13;
        t0 = b & 0xFFFF; t1 = b >> 16; t2 = a & 0xFFFF; t3 = a >> 16;
        rc[(*n_rc)++] = t0; rc[(*n_rc)++] = t1; rc[(*n_rc)++] = t2; rc[(*n_rc)++] = t3;
        row[COL_H + 2] = t0; row[COL_H + 3] = t1; row[COL_H + 4] = t2; row[COL_H + 5] = t3;
        break;
    }
    default: return -1;
    }
    return 0;
}

/* Execute a single-basic-block program, emitting trace rows.
 *
 * Inputs:
 *   groups       : n_batches * 8 group values
 *   n_groups     : per-batch group counts
 *   batch_of_op  : n_ops (which batch each op is in, ascending)
 *   op_code      : n_ops raw 7-bit opcodes (for the bit columns)
 *   op_kind/op_param/op_imm/op_has_imm : internal dispatch data
 *   stack_init   : 16 initial stack values (top first)
 *   digest       : 4-element block digest (for the END row)
 *   out          : (cap_rows, 51) row-major uint64 buffer
 *   rc_out       : range-check value buffer (>= 4 * n_ops)
 *   stack_cap    : capacity of the internal stack (>= 16 + pushes)
 * Outputs (via pointers): final depth, clk, n_rc.
 * Returns rows written, or negative error code.
 */
i64 run_block_segment(
    const u64 *groups, const i64 *n_groups, i64 n_batches,
    const i64 *batch_of_op, const u64 *op_code, const i64 *op_kind,
    const u64 *op_param, const u64 *op_imm, const u64 *op_has_imm,
    i64 n_ops,
    /* entry state: full stack (depth0 values, top first) + overflow clk
       stamps (newest first), clk/ctx/fn of the SPAN row, the block's
       hasher address and its parent's */
    const u64 *stack_init, i64 depth0, const u64 *ovf_clk_init,
    u64 clk0, u64 ctx, const u64 *fn_hash,
    u64 block_addr, u64 parent_addr, i64 write_end, i64 is_loop_body,
    const u64 *digest,
    u64 *out, i64 cap_rows, u64 *rc_out, i64 *n_rc_out,
    u64 *stack_buf, u64 *ovf_buf, i64 stack_cap,
    u64 *final_stack /* 16 */, u64 *final_ovf, u64 *final_ovf_clk,
    i64 *final_depth, u64 *final_clk) {

    Vm v;
    v.stack = stack_buf;
    v.ovf_clk = ovf_buf;
    v.depth = depth0;
    v.n_ovf = depth0 - MINDEPTH;
    v.clk = clk0;
    v.ctx = ctx;
    for (int i = 0; i < 4; i++) v.fn_hash[i] = fn_hash ? fn_hash[i] : 0;
    memset(stack_buf, 0, (size_t)stack_cap * 8);
    for (i64 i = 0; i < depth0; i++) v.stack[i] = stack_init[i];
    for (i64 i = 0; i < v.n_ovf; i++) v.ovf_clk[i] = ovf_clk_init[i];

    i64 row_i = 0;
    i64 n_rc = 0;
    u64 bflags[3];

    /* span decode state (miden_tpu_torch/vm/trace.py SpanState) */
    i64 total_groups = 0;
    for (i64 bi = 0; bi < n_batches; bi++) total_groups += n_groups[bi];

    u64 addr = block_addr;
    i64 gc = total_groups;
    i64 queue_head = 0, queue_len = 0; /* indices into groups of cur batch */
    const u64 *cur_groups = groups;
    u64 pending_group = 0;
    int have_pending = 0;
    u64 rem = 0;
    i64 op_index = 0;

    /* SPAN row (captured with the PARENT address, like
       TraceBuilder.on_span_start's _cur_addr()) */
    if (row_i >= cap_rows) return -2;
    batch_flags(n_groups[0], bflags);
    {
        u64 h[8];
        for (int i = 0; i < 8; i++) h[i] = groups[i];
        capture(out + row_i * W, &v, 0x56 /* SPAN */, parent_addr, h, 0,
                (u64)total_groups, 0, bflags);
        row_i++;
    }
    v.clk++;
    gc = total_groups - 1;
    cur_groups = groups;
    queue_head = 1;
    queue_len = n_groups[0] - 1;
    pending_group = groups[0];
    have_pending = 1;

    i64 cur_batch = 0;
    for (i64 oi = 0; oi < n_ops; oi++) {
        if (batch_of_op[oi] != cur_batch) {
            /* RESPAN */
            if (rem != 0 || queue_len != 0) return -3;
            cur_batch = batch_of_op[oi];
            cur_groups = groups + cur_batch * 8;
            if (row_i >= cap_rows) return -2;
            batch_flags(n_groups[cur_batch], bflags);
            u64 h[8];
            for (int i = 0; i < 8; i++) h[i] = cur_groups[i];
            capture(out + row_i * W, &v, 0x78 /* RESPAN */, addr, h, 0,
                    (u64)gc, 0, bflags);
            row_i++;
            v.clk++;
            addr += 2;
            gc -= 1;
            queue_head = 1;
            queue_len = n_groups[cur_batch] - 1;
            pending_group = cur_groups[0];
            have_pending = 1;
        }
        u64 code = op_code[oi];
        if (have_pending) {
            rem = (pending_group - code) >> 7;
            have_pending = 0;
            op_index = 0;
        } else {
            if ((rem & 0x7F) != code) return -4;
            rem >>= 7;
            op_index++;
        }
        if (row_i >= cap_rows) return -2;
        u64 *row = out + row_i * W;
        {
            /* h1 on every user-op row carries the parent block address
               (trace.py pre_op; trace_row.rs:99-118 new_operation) */
            u64 h[8] = {rem, parent_addr, 0, 0, 0, 0, 0, 0};
            capture(row, &v, code, addr, h, 1, (u64)gc, (u64)op_index, 0);
        }
        row_i++;
        /* group consumption bookkeeping */
        if (op_has_imm[oi]) {
            if (queue_len == 0 || cur_groups[queue_head] != op_imm[oi]) return -5;
            queue_head++; queue_len--;
            gc -= 1;
        } else if (rem == 0 && queue_len) {
            pending_group = cur_groups[queue_head];
            have_pending = 1;
            queue_head++; queue_len--;
            gc -= 1;
        }
        int rcres = exec_op(&v, (int)op_kind[oi], op_param[oi], op_imm[oi],
                            row, rc_out, &n_rc);
        if (rcres) return rcres;
        if (v.depth >= stack_cap - 1) return -6;
        v.clk++;
    }
    if (rem != 0 || queue_len != 0 || gc != 0) return -7;

    if (write_end) {
        /* END row */
        if (row_i >= cap_rows) return -2;
        u64 h[8] = {digest[0], digest[1], digest[2], digest[3],
                    (u64)is_loop_body, 0, 0, 0};
        capture(out + row_i * W, &v, 0x70 /* END */, addr, h, 0, 0, 0, 0);
        row_i++;
        v.clk++;
    }

    for (int i = 0; i < MINDEPTH; i++) final_stack[i] = v.stack[i];
    if (final_ovf)
        for (i64 i = 0; i < v.n_ovf; i++) final_ovf[i] = v.stack[MINDEPTH + i];
    if (final_ovf_clk)
        for (i64 i = 0; i < v.n_ovf; i++) final_ovf_clk[i] = v.ovf_clk[i];
    *final_depth = v.depth;
    *final_clk = v.clk;
    *n_rc_out = n_rc;
    return row_i;
}

/* ---------------------------------------------------------------------
 * Poseidon2 (width 12) — exact port of miden_tpu_torch/hash/poseidon2_host.py,
 * constants injected from Python (hash/constants.py) via p2_set_constants.
 * Used for the hasher-chiplet / Poseidon2PermutationAir trace builders,
 * which scale with decoded-op count (16 trace rows per permutation).
 * ------------------------------------------------------------------- */

static u64 P2_ARK_INIT[48];
static u64 P2_ARK_INT[22];
static u64 P2_ARK_TERM[48];
static u64 P2_DIAG[12];

void p2_set_constants(const u64 *ark_init, const u64 *ark_int,
                      const u64 *ark_term, const u64 *diag) {
    memcpy(P2_ARK_INIT, ark_init, sizeof P2_ARK_INIT);
    memcpy(P2_ARK_INT, ark_int, sizeof P2_ARK_INT);
    memcpy(P2_ARK_TERM, ark_term, sizeof P2_ARK_TERM);
    memcpy(P2_DIAG, diag, sizeof P2_DIAG);
}

static inline u64 p2_sbox(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x4 = gl_mul(x2, x2);
    return gl_mul(gl_mul(x4, x2), x);
}

static const u64 P2_M4[4][4] = {
    {2, 3, 1, 1}, {1, 2, 3, 1}, {1, 1, 2, 3}, {3, 1, 1, 2}};

static void p2_mds_external(u64 *s) {
    u64 out[12];
    for (int b = 0; b < 12; b += 4) {
        for (int r = 0; r < 4; r++) {
            u64 acc = 0;
            for (int j = 0; j < 4; j++) {
                u64 t = s[b + j];
                u64 m = P2_M4[r][j];
                u64 v = (m == 1) ? t : (m == 2) ? gl_add(t, t)
                                               : gl_add(gl_add(t, t), t);
                acc = gl_add(acc, v);
            }
            out[b + r] = acc;
        }
    }
    u64 sums[4];
    for (int l = 0; l < 4; l++)
        sums[l] = gl_add(gl_add(out[l], out[4 + l]), out[8 + l]);
    for (int i = 0; i < 12; i++) s[i] = gl_add(out[i], sums[i & 3]);
}

static inline u64 p2_internal(u64 *s, u64 rc) {
    u64 s0 = p2_sbox(gl_add(s[0], rc));
    u64 total = s0;
    for (int i = 1; i < 12; i++) total = gl_add(total, s[i]);
    for (int i = 0; i < 12; i++) {
        u64 base = (i == 0) ? s0 : s[i];
        s[i] = gl_add(total, gl_mul(P2_DIAG[i], base));
    }
    return s0;
}

static void p2_ext_round(u64 *s, const u64 *rc) {
    for (int i = 0; i < 12; i++) s[i] = p2_sbox(gl_add(s[i], rc[i]));
    p2_mds_external(s);
}

static void p2_permute(u64 *s) {
    p2_mds_external(s);
    for (int r = 0; r < 4; r++) p2_ext_round(s, P2_ARK_INIT + 12 * r);
    for (int r = 0; r < 22; r++) p2_internal(s, P2_ARK_INT[r]);
    for (int r = 0; r < 4; r++) p2_ext_round(s, P2_ARK_TERM + 12 * r);
}

/* Batch permute: states (k, 12) in place. */
void p2_permute_batch(u64 *states, i64 k) {
    for (i64 i = 0; i < k; i++) p2_permute(states + 12 * i);
}

/* Chained basic-block absorption: state_i = [batch_i(8) | cap_i(4)],
 * cap_0 = 0, cap_{i+1} = permute(state_i)[8..12]. Writes the pre-permute
 * states and the permuted outputs (hasher-chiplet input/output rows). */
void p2_chain_basic_block(const u64 *batches, i64 k, u64 *states_out,
                          u64 *outs_out) {
    u64 cap[4] = {0, 0, 0, 0};
    for (i64 i = 0; i < k; i++) {
        u64 *st = states_out + 12 * i;
        u64 *ot = outs_out + 12 * i;
        for (int j = 0; j < 8; j++) st[j] = batches[8 * i + j] % PGL;
        for (int j = 0; j < 4; j++) st[8 + j] = cap[j];
        memcpy(ot, st, 12 * 8);
        p2_permute(ot);
        memcpy(cap, ot + 8, 4 * 8);
    }
}

/* 16-row packed permutation schedule per cycle (hasher.md
 * §poseidon2-permutation-air; port of permute_packed_rows):
 *   row 0: initial linear layer + ext round 1; rows 1-3: ext rounds 2-4;
 *   rows 4-10: internal rounds ×3; row 11: last internal + term ext 1;
 *   rows 12-14: term ext 2-4; row 15: output.
 * states_rows: (k, 16, 12); wits: (k, 16, 3). */
void p2_packed_rows(const u64 *states, i64 k, u64 *states_rows, u64 *wits) {
    for (i64 c = 0; c < k; c++) {
        u64 s[12];
        for (int i = 0; i < 12; i++) s[i] = states[12 * c + i] % PGL;
        u64 *rows = states_rows + c * 16 * 12;
        u64 *w = wits + c * 16 * 3;
        memset(w, 0, 16 * 3 * 8);
        int r = 0;
        memcpy(rows + 12 * r, s, 96); r++;
        p2_mds_external(s);
        p2_ext_round(s, P2_ARK_INIT + 0);
        for (int e = 1; e < 4; e++) {
            memcpy(rows + 12 * r, s, 96); r++;
            p2_ext_round(s, P2_ARK_INIT + 12 * e);
        }
        for (int pack = 0; pack < 7; pack++) {
            memcpy(rows + 12 * r, s, 96);
            for (int j = 0; j < 3; j++)
                w[3 * r + j] = p2_internal(s, P2_ARK_INT[3 * pack + j]);
            r++;
        }
        memcpy(rows + 12 * r, s, 96);
        w[3 * r] = p2_internal(s, P2_ARK_INT[21]);
        p2_ext_round(s, P2_ARK_TERM + 0);
        r++;
        for (int e = 1; e < 4; e++) {
            memcpy(rows + 12 * r, s, 96); r++;
            p2_ext_round(s, P2_ARK_TERM + 12 * e);
        }
        memcpy(rows + 12 * r, s, 96);
    }
}
