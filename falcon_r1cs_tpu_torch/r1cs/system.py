"""R1CS constraint system: the trace-phase core of the framework.

TPU-native replacement for ark-relations' `ConstraintSystem` (SURVEY.md
section 2.3): variable allocation (instance/witness), linear-combination
storage, A/B/C sparse matrices, satisfiability, and counters
(`num_instance_variables / num_witness_variables / num_constraints`, printed
by `falcon-r1cs/examples/constraint_counts.rs:39-44`).

Design (SURVEY.md section 7): the reference executes `generate_constraints`
twice -- once in SETUP mode (shape only, values substituted by one, e.g.
`falcon-r1cs/src/gadgets/arithmetics.rs:58-67`) and once in
PROVING mode.  We keep the same two modes.  Tracing happens once per circuit
shape on host; the compiled artifact (COO matrices + witness layout) is what
the batched TPU engine consumes.

Variable encoding: instance i -> 2*i, witness j -> 2*j + 1.  The constant
"one" wire is instance 0 (so `num_instance_variables` starts at 1, matching
arkworks -- the published instance counts 1025/2049 are 2N inputs + one).
Linear combinations are dicts {encoded_var: coeff mod field_modulus}.
"""

from __future__ import annotations

from ..params import FIELD_MODULUS

ONE = 0  # encoded variable for the constant-one instance wire


def var_instance(i: int) -> int:
    return 2 * i


def var_witness(j: int) -> int:
    return 2 * j + 1


def is_witness(v: int) -> bool:
    return bool(v & 1)


def var_index(v: int) -> int:
    return v >> 1


def lc_scale(lc: dict, k: int, p: int) -> dict:
    k %= p
    if k == 0:
        return {}
    if k == 1:
        return dict(lc)
    return {v: c * k % p for v, c in lc.items()}


def lc_add_into(acc: dict, lc: dict, p: int, sign: int = 1) -> None:
    # coefficients are kept reduced in [0, p), so a single conditional
    # subtract/add replaces the (much costlier) 256-bit % per merge
    get = acc.get
    if sign == 1:
        for v, c in lc.items():
            nc = get(v, 0) + c
            if nc >= p:
                nc -= p
            if nc:
                acc[v] = nc
            else:
                del acc[v]
    else:
        for v, c in lc.items():
            nc = get(v, 0) - c
            if nc < 0:
                nc += p
            if nc:
                acc[v] = nc
            else:
                del acc[v]


class SynthesisError(Exception):
    pass


class ConstraintSystem:
    """A mutable R1CS being traced.

    mode: "prove" (values tracked, hints computed) or "setup" (shape only).
    validate: runtime analog of the reference's `#[cfg(not(test))] panic!`
        input guards (`falcon-r1cs/src/gadgets/range_proofs.rs:55-60`);
        tests pass validate=False to exercise unsatisfiable witnesses.
    """

    def __init__(
        self,
        field_modulus: int = FIELD_MODULUS,
        mode: str = "prove",
        validate: bool = True,
    ):
        if mode not in ("prove", "setup"):
            raise ValueError(f"bad mode {mode!r}")
        self.p = field_modulus
        self.mode = mode
        self.validate = validate
        self.instance_values: list[int] = [1]
        self.witness_values: list[int] = []
        self.a_rows: list[dict] = []
        self.b_rows: list[dict] = []
        self.c_rows: list[dict] = []
        # Rows whose satisfaction is inherently mod-p (field inverses in the
        # witness: is_eq/is_neq/is_zero) rather than integer-exact.  The
        # residue-CRT device checker (parallel/sat_check.py) excludes these
        # and checks them in exact host arithmetic instead.
        self.field_rows: set[int] = set()

    # -- counters (arkworks API parity) ------------------------------------
    @property
    def num_instance_variables(self) -> int:
        return len(self.instance_values)

    @property
    def num_witness_variables(self) -> int:
        return len(self.witness_values)

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    def is_in_setup_mode(self) -> bool:
        return self.mode == "setup"

    def counters(self) -> tuple[int, int, int]:
        """(instance, witness, constraints) snapshot for per-section deltas."""
        return (
            self.num_instance_variables,
            self.num_witness_variables,
            self.num_constraints,
        )

    # -- allocation --------------------------------------------------------
    def new_witness_variable(self, value) -> int:
        """Allocate a witness; `value` is an int or a 0-arg callable.

        In setup mode the callable is never invoked (arkworks semantics) and
        the stored value is None.
        """
        if self.mode == "setup":
            self.witness_values.append(None)
        else:
            v = value() if callable(value) else value
            self.witness_values.append(v % self.p)
        return var_witness(len(self.witness_values) - 1)

    def new_input_variable(self, value) -> int:
        if self.mode == "setup":
            self.instance_values.append(None)
        else:
            v = value() if callable(value) else value
            self.instance_values.append(v % self.p)
        return var_instance(len(self.instance_values) - 1)

    # -- constraints -------------------------------------------------------
    def enforce_constraint(self, a: dict, b: dict, c: dict) -> None:
        self.a_rows.append(a)
        self.b_rows.append(b)
        self.c_rows.append(c)

    # -- evaluation --------------------------------------------------------
    def value_of(self, v: int):
        if is_witness(v):
            return self.witness_values[var_index(v)]
        return self.instance_values[var_index(v)]

    def eval_lc(self, lc: dict) -> int:
        p = self.p
        acc = 0
        for v, c in lc.items():
            acc += c * self.value_of(v)
        return acc % p

    def which_unsatisfied(self):
        """Index of the first unsatisfied constraint, or None."""
        if self.mode == "setup":
            raise SynthesisError("cannot evaluate in setup mode")
        for i, (a, b, c) in enumerate(
            zip(self.a_rows, self.b_rows, self.c_rows)
        ):
            if self.eval_lc(a) * self.eval_lc(b) % self.p != self.eval_lc(c):
                return i
        return None

    def is_satisfied(self) -> bool:
        return self.which_unsatisfied() is None

    # -- export ------------------------------------------------------------
    def global_col(self, v: int) -> int:
        """arkworks matrix column layout: instance vars first, then witness."""
        if is_witness(v):
            return self.num_instance_variables + var_index(v)
        return var_index(v)

    def to_coo(self):
        """Export (A, B, C) as COO triples (rows, cols, vals).

        vals are Python ints mod p (values up to ~2^160 for NTT-bound
        constants, p-1 for negations); conversion to limb tensors is done by
        r1cs.coo / the parallel satisfiability checker.
        """
        out = []
        for rows in (self.a_rows, self.b_rows, self.c_rows):
            r, c, v = [], [], []
            for i, lc in enumerate(rows):
                for var, coeff in sorted(lc.items()):
                    r.append(i)
                    c.append(self.global_col(var))
                    v.append(coeff)
            out.append((r, c, v))
        return tuple(out)

    def full_assignment(self) -> list[int]:
        """[instance values | witness values] in matrix column order."""
        if self.mode == "setup":
            raise SynthesisError("no assignment in setup mode")
        return list(self.instance_values) + list(self.witness_values)
