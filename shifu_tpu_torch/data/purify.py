"""Row filter expressions (`dataSet.filterExpressions`) — the port's copy
of `shifu_tpu/data/purify.py`; numbers parse with `data/tokens.py`.

The reference evaluates Apache-JEXL expressions per row
(core/DataPurifier.java:37, udf/PurifyDataUDF.java:31). Here expressions are a
safe Python-expression subset compiled once and evaluated VECTORIZED over
numpy columns — each column name is bound to a ColumnVar that dispatches
comparisons numerically or lexically depending on the literal it meets, so
`column_4 > 10 and diagnosis == "M"` runs as array ops.

Supported: comparisons, and/or/not (rewritten to &, |, ~), arithmetic, and
`in` on literal lists (rewritten to isin).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from shifu_tpu_torch.data.tokens import to_numeric
from shifu_tpu_torch.utils.errors import ErrorCode, ShifuError

_ALLOWED_NODES = (
    ast.Expression, ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Compare,
    ast.Name, ast.Load, ast.Constant, ast.And, ast.Or, ast.Not,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.USub, ast.UAdd,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
    ast.List, ast.Tuple,
)
# Call/Attribute/BitAnd/BitOr/Invert appear only in the REWRITTEN tree (isin
# calls, &/|/~); user input is validated against the stricter set above first.


def _split_quoted(expr: str) -> List[Tuple[bool, str]]:
    """Split into (is_literal, text) segments so operator rewriting never
    touches the inside of quoted string literals."""
    out: List[Tuple[bool, str]] = []
    i, start = 0, 0
    while i < len(expr):
        ch = expr[i]
        if ch in ("'", '"'):
            if i > start:
                out.append((False, expr[start:i]))
            j = i + 1
            while j < len(expr) and expr[j] != ch:
                j += 1
            out.append((True, expr[i : min(j + 1, len(expr))]))
            i = j + 1
            start = i
        else:
            i += 1
    if start < len(expr):
        out.append((False, expr[start:]))
    return out


def _normalize_expr(expr: str) -> str:
    # JEXL-isms -> Python operators, outside string literals only.
    parts = []
    for is_lit, seg in _split_quoted(expr):
        if not is_lit:
            seg = (
                seg.replace("&&", " and ")
                .replace("||", " or ")
                .replace(" eq ", " == ")
                .replace(" ne ", " != ")
            )
        parts.append(seg)
    return "".join(parts)


class _Rewrite(ast.NodeTransformer):
    """and/or/not -> & / | / ~ (element-wise), `x in [..]` -> x.isin([..])."""

    def visit_BoolOp(self, node: ast.BoolOp):
        self.generic_visit(node)
        op = ast.BitAnd() if isinstance(node.op, ast.And) else ast.BitOr()
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.BinOp(left=out, op=op, right=v)
        return out

    def visit_UnaryOp(self, node: ast.UnaryOp):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.UnaryOp(op=ast.Invert(), operand=node.operand)
        return node

    def visit_Compare(self, node: ast.Compare):
        self.generic_visit(node)
        if len(node.ops) == 1 and isinstance(node.ops[0], (ast.In, ast.NotIn)):
            call = ast.Call(
                func=ast.Attribute(value=node.left, attr="isin", ctx=ast.Load()),
                args=[node.comparators[0]],
                keywords=[],
            )
            if isinstance(node.ops[0], ast.NotIn):
                return ast.UnaryOp(op=ast.Invert(), operand=call)
            return call
        # chain a < b < c into (a < b) & (b < c)
        if len(node.ops) > 1:
            parts = []
            left = node.left
            for op, comp in zip(node.ops, node.comparators):
                parts.append(ast.Compare(left=left, ops=[op], comparators=[comp]))
                left = comp
            out = parts[0]
            for p in parts[1:]:
                out = ast.BinOp(left=out, op=ast.BitAnd(), right=p)
            return out
        return node


class ColumnVar:
    """A column bound into a filter expression: raw strings + lazy numeric
    view; comparisons pick the representation from the operand type."""

    def __init__(self, raw: np.ndarray):
        self._raw = raw
        self._num: Optional[np.ndarray] = None

    def _numeric(self) -> np.ndarray:
        if self._num is None:
            self._num = to_numeric(self._raw)
        return self._num

    def _strings(self) -> np.ndarray:
        return np.asarray([str(v).strip() for v in self._raw], dtype=object)

    def _pick(self, other) -> np.ndarray:
        if isinstance(other, (int, float, np.ndarray, ColumnVar)) and not isinstance(
            other, bool
        ):
            return self._numeric()
        return self._strings()

    @staticmethod
    def _rhs(other):
        return other._numeric() if isinstance(other, ColumnVar) else other

    def __gt__(self, other):
        return self._pick(other) > self._rhs(other)

    def __ge__(self, other):
        return self._pick(other) >= self._rhs(other)

    def __lt__(self, other):
        return self._pick(other) < self._rhs(other)

    def __le__(self, other):
        return self._pick(other) <= self._rhs(other)

    def __eq__(self, other):  # noqa: D105
        return self._pick(other) == self._rhs(other)

    def __ne__(self, other):  # noqa: D105
        return self._pick(other) != self._rhs(other)

    def __add__(self, other):
        return self._numeric() + self._rhs(other)

    def __radd__(self, other):
        return other + self._numeric()

    def __sub__(self, other):
        return self._numeric() - self._rhs(other)

    def __rsub__(self, other):
        return other - self._numeric()

    def __mul__(self, other):
        return self._numeric() * self._rhs(other)

    def __rmul__(self, other):
        return other * self._numeric()

    def __truediv__(self, other):
        return self._numeric() / self._rhs(other)

    def __rtruediv__(self, other):
        return other / self._numeric()

    def __mod__(self, other):
        return self._numeric() % self._rhs(other)

    def isin(self, values: Sequence) -> np.ndarray:
        vals = list(values)
        if vals and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
            return np.isin(self._numeric(), vals)
        return np.isin(self._strings(), [str(v) for v in vals])

    __hash__ = None  # type: ignore[assignment]


class DataPurifier:
    """Compile a filter expression once; apply to a column dict -> bool mask."""

    def __init__(self, expression: Optional[str]):
        self.expression = (expression or "").strip()
        self._code = None
        if self.expression:
            src = _normalize_expr(self.expression)
            try:
                tree = ast.parse(src, mode="eval")
            except SyntaxError as e:
                raise ShifuError(ErrorCode.INVALID_FILTER_EXPR, f"{expression}: {e}")
            for node in ast.walk(tree):
                if not isinstance(node, _ALLOWED_NODES):
                    raise ShifuError(
                        ErrorCode.INVALID_FILTER_EXPR,
                        f"{expression}: disallowed construct {type(node).__name__}",
                    )
            tree = ast.fix_missing_locations(_Rewrite().visit(tree))
            self._code = compile(tree, "<filter>", "eval")

    def mask(self, columns: Dict[str, np.ndarray], n_rows: int) -> np.ndarray:
        """Evaluate to a boolean keep-mask of length n_rows."""
        if self._code is None:
            return np.ones(n_rows, dtype=bool)
        # bind ONLY the columns the expression references — `columns` may be
        # a lazy frame-backed mapping where touching a column materializes
        # it (data/reader.LazyColumns); iterating all of them would defeat
        # the bounded-memory ingest
        env = {
            name: ColumnVar(columns[name])
            for name in self._code.co_names
            if name in columns
        }
        try:
            out = eval(self._code, {"__builtins__": {}}, env)  # noqa: S307
        except Exception as e:
            raise ShifuError(ErrorCode.INVALID_FILTER_EXPR, f"{self.expression}: {e}")
        result = np.asarray(out)
        if result.shape == ():
            result = np.full(n_rows, bool(result))
        # NaN comparisons are False already; ensure boolean dtype
        return result.astype(bool)


def combined_mask(
    expressions: Optional[Union[str, Sequence[str]]],
    columns: Dict[str, np.ndarray],
    n_rows: int,
) -> np.ndarray:
    """Multiple expressions may be a list or ';'-separated — all must pass
    (the reference ANDs its filter-expression list)."""
    if not expressions:
        return np.ones(n_rows, dtype=bool)
    if isinstance(expressions, str):
        # split on ';' outside quoted literals only
        expr_list: List[str] = []
        buf = ""
        for is_lit, seg in _split_quoted(expressions):
            if is_lit:
                buf += seg
            else:
                chunks = seg.split(";")
                buf += chunks[0]
                for extra in chunks[1:]:
                    expr_list.append(buf)
                    buf = extra
        expr_list.append(buf)
    else:
        expr_list = list(expressions)
    mask = np.ones(n_rows, dtype=bool)
    for expr in expr_list:
        expr = expr.strip()
        if expr:
            mask &= DataPurifier(expr).mask(columns, n_rows)
    return mask
