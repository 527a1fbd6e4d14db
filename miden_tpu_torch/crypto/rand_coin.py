"""Poseidon2 RandomCoin — reseedable sponge PRG (rand/coin.rs).

Simplified SPONGE_PRG (eprint 2011/499): state = Poseidon2 width-12; seed
and reseed add a Word into the first half of the rate then permute; draws
stream rate elements left to right, permuting on exhaustion.
"""

from __future__ import annotations

from ..field import gl
from ..hash import poseidon2_host as hp

RATE_START = 0
RATE_END = 8


class RandomCoin:
    def __init__(self, seed=(0, 0, 0, 0)):
        state = [0] * 12
        for i in range(4):
            state[RATE_START + i] = (state[RATE_START + i] + seed[i]) % gl.P
        self.state = hp.permute(state)
        self.current = RATE_START

    @classmethod
    def from_parts(cls, state, current) -> "RandomCoin":
        assert RATE_START <= current <= RATE_END
        coin = cls.__new__(cls)
        coin.state = [v % gl.P for v in state]
        coin.current = current
        return coin

    def into_parts(self):
        return list(self.state), self.current

    def draw(self) -> int:
        if self.current == RATE_END:
            self.state = hp.permute(self.state)
            self.current = RATE_START
        self.current += 1
        return self.state[self.current - 1]

    draw_basefield = draw

    def draw_ext(self) -> tuple:
        return (self.draw(), self.draw())

    def draw_word(self) -> list[int]:
        return [self.draw() for _ in range(4)]

    def reseed(self, data) -> None:
        self.current = RATE_START
        for i in range(4):
            self.state[RATE_START + i] = (self.state[RATE_START + i] + data[i]) % gl.P
        self.state = hp.permute(self.state)

    # byte stream (rand_core fill_bytes_via_next_word over u32 draws)
    def next_u32(self) -> int:
        return self.draw() & 0xFFFFFFFF

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def fill_bytes(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += self.next_u32().to_bytes(4, "little")
        return bytes(out[:n])
