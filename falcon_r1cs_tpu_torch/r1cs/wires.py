"""Symbolic wires: FpVar and Boolean with arkworks-pinned cost semantics.

TPU-native replacement for ark-r1cs-std's `FpVar` / `Boolean` (SURVEY.md
section 2.3 and section 7 "hard part 1").  The cost model below is pinned by
solving the reference's six published golden totals
(`falcon-r1cs/README.md:41-56`) together with the per-gadget structure;
it reproduces all six exactly:

  op                                    constraints  witness vars
  -----------------------------------   -----------  ------------
  new_witness / new_input (FpVar)            0             1 (witness only)
  new_constant                               0             0
  Var +/- Var, Var * const, double           0             0   (pure LC)
  Var * Var (mul)                            1             1
  FpVar.enforce_equal                        1             0
  FpVar.is_eq / is_neq / is_zero             3             2
  conditionally_select (non-const cond)      1             1
  Boolean.new_witness                        1             1   (booleanity)
  Boolean and/or (non-const operands)        1             1
  Boolean not / is_eq vs constant            0             0
  Boolean.enforce_equal vs constant          1             0
  kary_or/kary_and over k wires            k-1           k-1

Note the reference's own doc comments are off-by-one in places -- e.g.
`enforce_less_than_q` says 28 constraints
(`falcon-r1cs/src/gadgets/range_proofs.rs:40`) but the
published totals force 29 (14 booleanity + 1 decompose + 13 logic + 1
enforce-true); similarly the 512 norm bound is 52, not 47.  The golden
totals, not the comments, are the contract.

Witness VALUE semantics (bit-exactness contract, BASELINE.md):
  - `or(a, b)` allocates the NOR value (1-a)(1-b) (the result is its Not);
  - `and` allocates the AND value;
  - `conditionally_select` allocates the selected value with constraint
    cond * (t - f) = result - f;
  - `is_neq` allocates [is_not_equal, multiplier] in that order, where
    multiplier = (a-b)^-1 if a != b else 1 (arkworks convention);
  - `mul` allocates the product.
"""

from __future__ import annotations

from .system import ONE, ConstraintSystem, SynthesisError, lc_add_into, lc_scale


class FpVar:
    """A field wire: either a compile-time constant or a linear combination.

    Matches arkworks `FpVar = Constant(F) | Var(AllocatedFp)`; arkworks
    commits intermediate LCs into the cs's lc_map via new_lc, which we skip
    (LCs are kept symbolic until a constraint consumes them) -- this changes
    nothing about counts, witness values, or the flattened matrices.
    """

    __slots__ = ("cs", "lc", "value", "const")

    def __init__(self, cs, lc=None, value=None, const=None):
        self.cs = cs
        self.lc = lc          # dict var->coeff, or None for constants
        self.value = value    # int mod p, or None in setup mode
        self.const = const    # int for constants, else None

    # -- constructors ------------------------------------------------------
    @staticmethod
    def constant(cs: ConstraintSystem, value: int) -> "FpVar":
        return FpVar(cs, const=value % cs.p)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value) -> "FpVar":
        var = cs.new_witness_variable(value)
        val = None if cs.is_in_setup_mode() else cs.value_of(var)
        return FpVar(cs, lc={var: 1}, value=val)

    @staticmethod
    def new_input(cs: ConstraintSystem, value) -> "FpVar":
        var = cs.new_input_variable(value)
        val = None if cs.is_in_setup_mode() else cs.value_of(var)
        return FpVar(cs, lc={var: 1}, value=val)

    @staticmethod
    def new_variable(cs: ConstraintSystem, value, mode: str) -> "FpVar":
        """mode in {"constant", "witness", "input"} (AllocationMode parity)."""
        if mode == "constant":
            v = value() if callable(value) else value
            return FpVar.constant(cs, v)
        if mode == "witness":
            return FpVar.new_witness(cs, value)
        if mode == "input":
            return FpVar.new_input(cs, value)
        raise ValueError(f"bad allocation mode {mode!r}")

    # -- helpers -----------------------------------------------------------
    @property
    def is_constant(self) -> bool:
        return self.const is not None

    def as_lc(self) -> dict:
        if self.is_constant:
            return {ONE: self.const} if self.const else {}
        return self.lc

    def _val(self):
        return self.const if self.is_constant else self.value

    # -- linear ops (free) -------------------------------------------------
    def __add__(self, other: "FpVar") -> "FpVar":
        cs = self.cs
        if self.is_constant and other.is_constant:
            return FpVar.constant(cs, self.const + other.const)
        a, b = self.as_lc(), other.as_lc()
        if len(a) < len(b):
            a, b = b, a
        lc = dict(a)
        lc_add_into(lc, b, cs.p)
        sv, ov = self._val(), other._val()
        val = None if sv is None or ov is None else (sv + ov) % cs.p
        return FpVar(cs, lc=lc, value=val)

    def __sub__(self, other: "FpVar") -> "FpVar":
        cs = self.cs
        if self.is_constant and other.is_constant:
            return FpVar.constant(cs, self.const - other.const)
        lc = dict(self.as_lc())
        lc_add_into(lc, other.as_lc(), cs.p, sign=-1)
        sv, ov = self._val(), other._val()
        val = None if sv is None or ov is None else (sv - ov) % cs.p
        return FpVar(cs, lc=lc, value=val)

    def double(self) -> "FpVar":
        return self.scale(2)

    def scale(self, k: int) -> "FpVar":
        cs = self.cs
        if self.is_constant:
            return FpVar.constant(cs, self.const * k)
        val = None if self.value is None else self.value * k % cs.p
        return FpVar(cs, lc=lc_scale(self.lc, k, cs.p), value=val)

    def negate(self) -> "FpVar":
        return self.scale(-1)

    # -- multiplicative ops ------------------------------------------------
    def __mul__(self, other: "FpVar") -> "FpVar":
        """wire x constant: free LC scale.  wire x wire: 1 witness + 1
        constraint (arkworks AllocatedFp::mul)."""
        cs = self.cs
        if self.is_constant:
            return other.scale(self.const)
        if other.is_constant:
            return self.scale(other.const)
        if cs.is_in_setup_mode():
            w = cs.new_witness_variable(0)
            val = None
        else:
            val = self.value * other.value % cs.p
            w = cs.new_witness_variable(val)
        cs.enforce_constraint(dict(self.lc), dict(other.lc), {w: 1})
        return FpVar(cs, lc={w: 1}, value=val)

    def square(self) -> "FpVar":
        return self * self

    # -- equality ----------------------------------------------------------
    def enforce_equal(self, other: "FpVar") -> None:
        cs = self.cs
        if self.is_constant and other.is_constant:
            if self.const != other.const:
                raise SynthesisError("constant enforce_equal mismatch")
            return
        # (self - other) * 1 = 0
        lc = dict(self.as_lc())
        lc_add_into(lc, other.as_lc(), cs.p, sign=-1)
        cs.enforce_constraint(lc, {ONE: 1}, {})

    def is_neq(self, other: "FpVar") -> "Boolean":
        """arkworks AllocatedFp::is_neq: 2 witnesses + 3 constraints.

        Allocation order: is_not_equal boolean (with booleanity), then
        multiplier.  multiplier = (a-b)^-1 when a != b, else 1.
        Constraints: (a-b)*m = is_neq ; (a-b)*(1-is_neq) = 0.
        """
        cs = self.cs
        if self.is_constant and other.is_constant:
            return Boolean.constant(cs, self.const != other.const)
        sv, ov = self._val(), other._val()
        if cs.is_in_setup_mode():
            neq_val = False
            mult_val = 0
        else:
            diff = (sv - ov) % cs.p
            neq_val = diff != 0
            mult_val = pow(diff, cs.p - 2, cs.p) if neq_val else 1
        is_not_equal = Boolean.new_witness(cs, neq_val)
        m = cs.new_witness_variable(mult_val)
        diff_lc = dict(self.as_lc())
        lc_add_into(diff_lc, other.as_lc(), cs.p, sign=-1)
        cs.field_rows.add(cs.num_constraints)
        cs.enforce_constraint(dict(diff_lc), {m: 1}, is_not_equal.lc())
        cs.enforce_constraint(dict(diff_lc), is_not_equal.not_().lc(), {})
        return is_not_equal

    def is_eq(self, other: "FpVar") -> "Boolean":
        return self.is_neq(other).not_()

    def is_zero(self) -> "Boolean":
        """FieldVar::is_zero = is_eq(zero) (`is_zero` use:
        `falcon-r1cs/src/gadgets/dual_poly.rs:28`)."""
        return self.is_eq(FpVar.constant(self.cs, 0))

    # -- selection ---------------------------------------------------------
    @staticmethod
    def conditionally_select(
        cond: "Boolean", t: "FpVar", f: "FpVar"
    ) -> "FpVar":
        """arkworks CondSelectGadget: result witness holds the selected value;
        constraint cond * (t - f) = result - f.  1 witness + 1 constraint."""
        cs = cond.cs
        if cond.kind == "const":
            return t if cond.bval else f
        if cs.is_in_setup_mode():
            w = cs.new_witness_variable(0)
            val = None
        else:
            val = t._val() if cond.value() else f._val()
            w = cs.new_witness_variable(val)
        t_minus_f = dict(t.as_lc())
        lc_add_into(t_minus_f, f.as_lc(), cs.p, sign=-1)
        res_minus_f = {w: 1}
        lc_add_into(res_minus_f, f.as_lc(), cs.p, sign=-1)
        cs.enforce_constraint(cond.lc(), t_minus_f, res_minus_f)
        return FpVar(cs, lc={w: 1}, value=val)

    @staticmethod
    def from_boolean(b: "Boolean") -> "FpVar":
        """FpVar::from(Boolean): the boolean's LC, free."""
        cs = b.cs
        if b.kind == "const":
            return FpVar.constant(cs, 1 if b.bval else 0)
        val = None
        if not cs.is_in_setup_mode():
            val = 1 if b.value() else 0
        return FpVar(cs, lc=b.lc(), value=val)


class Boolean:
    """A boolean wire: Constant | Is(var) | Not(var) (arkworks `Boolean`)."""

    __slots__ = ("cs", "kind", "var", "bval")

    def __init__(self, cs, kind, var=None, bval=None):
        self.cs = cs
        self.kind = kind  # "const" | "is" | "not"
        self.var = var    # encoded witness var for is/not
        self.bval = bval  # bool: the boolean's VALUE (post-Not), None in setup

    # -- constructors ------------------------------------------------------
    @staticmethod
    def constant(cs, value: bool) -> "Boolean":
        return Boolean(cs, "const", bval=bool(value))

    @staticmethod
    def TRUE(cs) -> "Boolean":
        return Boolean.constant(cs, True)

    @staticmethod
    def FALSE(cs) -> "Boolean":
        return Boolean.constant(cs, False)

    @staticmethod
    def new_witness(cs: ConstraintSystem, value) -> "Boolean":
        """1 witness + 1 booleanity constraint (1 - a) * a = 0."""
        if cs.is_in_setup_mode():
            w = cs.new_witness_variable(0)
            bval = None
        else:
            bval = bool(value() if callable(value) else value)
            w = cs.new_witness_variable(1 if bval else 0)
        cs.enforce_constraint({ONE: 1, w: cs.p - 1}, {w: 1}, {})
        return Boolean(cs, "is", var=w, bval=bval)

    @staticmethod
    def _new_witness_no_booleanity(cs, bval) -> "Boolean":
        if cs.is_in_setup_mode():
            w = cs.new_witness_variable(0)
            return Boolean(cs, "is", var=w, bval=None)
        w = cs.new_witness_variable(1 if bval else 0)
        return Boolean(cs, "is", var=w, bval=bval)

    # -- helpers -----------------------------------------------------------
    def value(self) -> bool:
        if self.kind == "const":
            return self.bval
        if self.bval is None:
            raise SynthesisError("no boolean value in setup mode")
        return self.bval

    def lc(self) -> dict:
        p = self.cs.p
        if self.kind == "const":
            return {ONE: 1} if self.bval else {}
        if self.kind == "is":
            return {self.var: 1}
        return {ONE: 1, self.var: p - 1}  # Not(w) -> 1 - w

    def not_(self) -> "Boolean":
        if self.kind == "const":
            return Boolean.constant(self.cs, not self.bval)
        kind = "not" if self.kind == "is" else "is"
        bval = None if self.bval is None else not self.bval
        return Boolean(self.cs, kind, var=self.var, bval=bval)

    # -- logic (arkworks formulas; counts in module docstring) -------------
    def and_(self, other: "Boolean") -> "Boolean":
        cs = self.cs
        if self.kind == "const":
            return other if self.bval else Boolean.constant(cs, False)
        if other.kind == "const":
            return self if other.bval else Boolean.constant(cs, False)
        bval = None
        if not cs.is_in_setup_mode():
            bval = self.value() and other.value()
        res = Boolean._new_witness_no_booleanity(cs, bval)
        cs.enforce_constraint(self.lc(), other.lc(), {res.var: 1})
        return res

    def or_(self, other: "Boolean") -> "Boolean":
        """not(and(not a, not b)): allocates the NOR value (1-a)(1-b); the
        returned Boolean is its Not."""
        cs = self.cs
        if self.kind == "const":
            return Boolean.constant(cs, True) if self.bval else other
        if other.kind == "const":
            return Boolean.constant(cs, True) if other.bval else self
        na, nb = self.not_(), other.not_()
        nor = na.and_(nb)
        return nor.not_()

    def xor(self, other: "Boolean") -> "Boolean":
        cs = self.cs
        if self.kind == "const":
            return other.not_() if self.bval else other
        if other.kind == "const":
            return self.not_() if other.bval else self
        # general case (unused by the Falcon gadgets, provided for parity):
        # constraint (2a) * b = a + b - c
        bval = None
        if not cs.is_in_setup_mode():
            bval = self.value() != other.value()
        res = Boolean._new_witness_no_booleanity(cs, bval)
        two_a = lc_scale(self.lc(), 2, cs.p)
        rhs = dict(self.lc())
        lc_add_into(rhs, other.lc(), cs.p)
        lc_add_into(rhs, {res.var: 1}, cs.p, sign=-1)
        cs.enforce_constraint(two_a, other.lc(), rhs)
        return res

    @staticmethod
    def kary_or(bits: list["Boolean"]) -> "Boolean":
        """Left fold of or (arkworks kary_or): k-1 allocs for k wires."""
        if not bits:
            raise SynthesisError("kary_or of empty list")
        cur = bits[0]
        for b in bits[1:]:
            cur = cur.or_(b)
        return cur

    @staticmethod
    def kary_and(bits: list["Boolean"]) -> "Boolean":
        if not bits:
            raise SynthesisError("kary_and of empty list")
        cur = bits[0]
        for b in bits[1:]:
            cur = cur.and_(b)
        return cur

    # -- equality ----------------------------------------------------------
    def is_eq(self, other: "Boolean") -> "Boolean":
        """xor(a, b).not(); free when one side is constant."""
        return self.xor(other).not_()

    def enforce_equal(self, other: "Boolean") -> None:
        """1 constraint: lc(self) * 1 = lc(other)."""
        cs = self.cs
        if self.kind == "const" and other.kind == "const":
            if self.bval != other.bval:
                raise SynthesisError("constant boolean enforce_equal mismatch")
            return
        cs.enforce_constraint(self.lc(), {ONE: 1}, other.lc())
