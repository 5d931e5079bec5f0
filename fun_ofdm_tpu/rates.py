"""802.11a MCS rate table.

Port of the reference rate table (reference: src/rates.h:21-250).
Eleven rates: the eight standard 802.11a MCS plus the reference's three
nonstandard entries (2/3-BPSK 0xE, 2/3-QPSK 0x6, 2/3-QAM16 0xA).

Rates are *static* (compile-time) configuration in this framework: every
jitted TX/RX function is specialized per rate, so rate parameters live in
plain Python (an IntEnum plus a frozen dataclass), never inside traced code.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from fractions import Fraction


class Rate(enum.IntEnum):
    """PHY data rates, coding rate + modulation (reference: src/rates.h:31-44)."""

    RATE_1_2_BPSK = 0
    RATE_2_3_BPSK = 1
    RATE_3_4_BPSK = 2
    RATE_1_2_QPSK = 3
    RATE_2_3_QPSK = 4
    RATE_3_4_QPSK = 5
    RATE_1_2_QAM16 = 6
    RATE_2_3_QAM16 = 7
    RATE_3_4_QAM16 = 8
    RATE_2_3_QAM64 = 9
    RATE_3_4_QAM64 = 10


@dataclass(frozen=True)
class RateParams:
    """Parameters for one PHY rate (reference: src/rates.h:52-60).

    Attributes:
      rate:       the Rate enum value.
      rate_field: 4-bit SIGNAL-field rate code.
      cbps:       coded bits per OFDM symbol.
      dbps:       data bits per OFDM symbol.
      bpsc:       coded bits per subcarrier (modulation order log2).
      rel_rate:   output/input length ratio of the puncturer
                  (1 for rate-1/2, 3/4 for rate-2/3, 2/3 for rate-3/4).
      name:       display name.
    """

    rate: Rate
    rate_field: int
    cbps: int
    dbps: int
    bpsc: int
    rel_rate: Fraction
    name: str

    @property
    def coding_rate(self) -> Fraction:
        """The convolutional coding rate (1/2, 2/3, or 3/4)."""
        return Fraction(1, 2) / self.rel_rate

    def num_symbols(self, length: int) -> int:
        """OFDM data symbols for a `length`-byte payload.

        ceil((16 service + 8*(length+4 CRC) + 6 tail) / dbps)
        (reference: src/ppdu.cpp:38-40).
        """
        bits = 16 + 8 * (length + 4) + 6
        return -(-bits // self.dbps)

    def num_data_bits(self, length: int) -> int:
        """Padded data bits for a `length`-byte payload (num_symbols*dbps)."""
        return self.num_symbols(length) * self.dbps

    def num_data_bytes(self, length: int) -> int:
        """Whole bytes of padded data (floor; reference src/ppdu.cpp:124)."""
        return self.num_data_bits(length) // 8

    def frame_samples(self, length: int) -> int:
        """Total time-domain samples in a built frame.

        320 preamble + 80 * (1 SIGNAL + num_symbols)
        (reference: src/frame_builder.cpp:67-78).
        """
        return 320 + 80 * (1 + self.num_symbols(length))


_F12, _F23, _F34 = Fraction(1), Fraction(3, 4), Fraction(2, 3)

RATE_PARAMS: dict[Rate, RateParams] = {
    Rate.RATE_1_2_BPSK: RateParams(Rate.RATE_1_2_BPSK, 0xD, 48, 24, 1, _F12, "1/2 BPSK"),
    Rate.RATE_2_3_BPSK: RateParams(Rate.RATE_2_3_BPSK, 0xE, 48, 32, 1, _F23, "2/3 BPSK"),
    Rate.RATE_3_4_BPSK: RateParams(Rate.RATE_3_4_BPSK, 0xF, 48, 36, 1, _F34, "3/4 BPSK"),
    Rate.RATE_1_2_QPSK: RateParams(Rate.RATE_1_2_QPSK, 0x5, 96, 48, 2, _F12, "1/2 QPSK"),
    Rate.RATE_2_3_QPSK: RateParams(Rate.RATE_2_3_QPSK, 0x6, 96, 64, 2, _F23, "2/3 QPSK"),
    Rate.RATE_3_4_QPSK: RateParams(Rate.RATE_3_4_QPSK, 0x7, 96, 72, 2, _F34, "3/4 QPSK"),
    Rate.RATE_1_2_QAM16: RateParams(Rate.RATE_1_2_QAM16, 0x9, 192, 96, 4, _F12, "1/2 QAM16"),
    Rate.RATE_2_3_QAM16: RateParams(Rate.RATE_2_3_QAM16, 0xA, 192, 128, 4, _F23, "2/3 QAM16"),
    Rate.RATE_3_4_QAM16: RateParams(Rate.RATE_3_4_QAM16, 0xB, 192, 144, 4, _F34, "3/4 QAM16"),
    Rate.RATE_2_3_QAM64: RateParams(Rate.RATE_2_3_QAM64, 0x1, 288, 192, 6, _F23, "2/3 QAM64"),
    Rate.RATE_3_4_QAM64: RateParams(Rate.RATE_3_4_QAM64, 0x3, 288, 216, 6, _F34, "3/4 QAM64"),
}

#: Valid SIGNAL rate-field values (reference: src/rates.h:21).
VALID_RATE_FIELDS: tuple[int, ...] = (0xD, 0xE, 0xF, 0x5, 0x6, 0x7, 0x9, 0xA, 0xB, 0x1, 0x3)

_BY_FIELD = {p.rate_field: p for p in RATE_PARAMS.values()}


def params_for(rate: Rate) -> RateParams:
    """RateParams for a Rate enum value."""
    return RATE_PARAMS[Rate(rate)]


def from_rate_field(rate_field: int) -> RateParams:
    """RateParams from the 4-bit SIGNAL rate field (reference: src/rates.h:208-249)."""
    return _BY_FIELD[rate_field]


ALL_RATES: tuple[Rate, ...] = tuple(Rate)
