"""System events: host-side advice hooks dispatched by the EMIT operation.

Behavioral spec: core/src/events/ — `EventId` = first LE u64 of Blake3-256
of the event name, reduced mod p (core/src/events/mod.rs:40-52); the
`SystemEvent` enum and its `sys::*` names (core/src/events/sys_events.rs);
handler semantics from
processor/src/fast/basic_block/sys_event_handlers.rs. The assembler lowers
a system event to `push.<event_id> emit drop`
(crates/assembly/src/basic_block_builder.rs:139-142), so during a handler
the event id sits at stack position 0 and operands start at position 1.
"""

from __future__ import annotations

from ..field import gl
from ..hash.blake3_host import blake3

P = gl.P


def hash_string_to_word(value: str) -> tuple[int, int, int, int]:
    """Blake3-256 of the string as 4 LE u64s (core/src/utils/mod.rs:50)."""
    d = blake3(value.encode())
    return tuple(int.from_bytes(d[i : i + 8], "little") for i in range(0, 32, 8))


def error_code_from_msg(msg: str) -> int:
    """First element of hash_string_to_word (core/src/mast/mod.rs:1309)."""
    return hash_string_to_word(msg)[0]


def event_id(name: str) -> int:
    """Canonical event id for a name (core/src/events/mod.rs:40-52)."""
    return hash_string_to_word(name)[0] % P


SYSTEM_EVENT_NAMES = [
    # core/src/events/sys_events.rs LOOKUP table order
    "sys::merkle_node_merge",
    "sys::merkle_node_to_stack",
    "sys::map_value_to_stack",
    "sys::map_value_count_to_stack",
    "sys::map_value_to_stack_n_0",
    "sys::map_value_to_stack_n_4",
    "sys::map_value_to_stack_n_8",
    "sys::has_map_key",
    "sys::ext2_inv",
    "sys::u32_clz",
    "sys::u32_ctz",
    "sys::u32_clo",
    "sys::u32_cto",
    "sys::ilog2",
    "sys::mem_to_map",
    "sys::hdword_to_map",
    "sys::hdword_to_map_with_domain",
    "sys::hqword_to_map",
    "sys::hperm_to_map",
]

SYSTEM_EVENT_IDS = {name: event_id(name) for name in SYSTEM_EVENT_NAMES}
SYSTEM_EVENT_BY_ID = {v: k for k, v in SYSTEM_EVENT_IDS.items()}
