"""Per-section constraint/witness counters: first-class API for the
introspection the reference does by hand with commented-out println probes
(`falcon-r1cs/src/circuits/falcon_ntt.rs:97-103,152-157`,
`examples/constraint_counts.rs:39-44`; SURVEY.md section 5)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..r1cs.system import ConstraintSystem


@dataclass
class SectionDelta:
    name: str
    instance: int
    witness: int
    constraints: int

    def __str__(self):
        return (
            f"{self.name}: +{self.instance} instance, +{self.witness} "
            f"witness, +{self.constraints} constraints"
        )


@dataclass
class CounterLog:
    """Collects named section deltas during a trace.

    Usage:
        log = CounterLog(cs)
        with log.section("range proofs"):
            ...
        print(log.table())
    """

    cs: ConstraintSystem
    sections: list = field(default_factory=list)

    def section(self, name: str):
        return _Section(self, name)

    def table(self) -> str:
        w = max((len(s.name) for s in self.sections), default=4)
        lines = [
            f"{'section':{w}} | instance | witness | constraints",
            "-" * (w + 37),
        ]
        for s in self.sections:
            lines.append(
                f"{s.name:{w}} | {s.instance:8} | {s.witness:7} | {s.constraints:11}"
            )
        return "\n".join(lines)


class _Section:
    def __init__(self, log: CounterLog, name: str):
        self.log = log
        self.name = name

    def __enter__(self):
        self.before = self.log.cs.counters()
        return self

    def __exit__(self, *exc):
        after = self.log.cs.counters()
        i, w, c = (a - b for a, b in zip(after, self.before))
        self.log.sections.append(SectionDelta(self.name, i, w, c))
        return False
