"""Embedded builtin grammar definitions (paper §4.7).

These are the source of truth for the builtin grammars; `load_grammar`
falls back to them when no `<name>.lark` override file is present in this
package directory, so the repo needs no checked-in data files and the
test-suite / examples / benchmarks work from a bare checkout. Dropping a
`<name>.lark` file next to this module still overrides (or extends) the
builtins — that remains the user extension path.

Syntax is the Lark subset documented in `repro.core.grammar`.
"""
from __future__ import annotations

JSON = r"""
// RFC-8259-shaped JSON (byte-level strings, no unicode validation).
start: value
value: object | array | STRING | NUMBER | "true" | "false" | "null"
object: "{" [pair ("," pair)*] "}"
pair: STRING ":" value
array: "[" [value ("," value)*] "]"

STRING: /"(\\.|[^"\\])*"/
NUMBER: /-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?/
WS: /[ \t\r\n]+/
%ignore WS
"""

CALC = r"""
// Arithmetic with a few math_* builtins. Deliberately has NO identifier
// terminal: unknown bytes (e.g. '@') are immediate lex errors, and
// "math_sqrt" is a literal keyword token (__MATH_SQRT).
start: expr
expr: term | expr "+" term | expr "-" term
term: factor | term "*" factor | term "/" factor
factor: atom | "-" factor
atom: INT | FLOAT | func | "(" expr ")"
func: ("math_sqrt" | "math_sin" | "math_cos" | "math_exp") "(" expr ")"

INT: /[0-9]+/
FLOAT: /[0-9]+\.[0-9]+([eE][+-]?[0-9]+)?/
WS: /[ \t\n]+/
%ignore WS
"""

SQL = r"""
// A SELECT-only SQL subset (uppercase keywords, lowercase identifiers —
// the case split keeps keywords and NAME disjoint in the lexer).
start: query
query: "SELECT" select_list "FROM" NAME [where_clause] [order_clause] [limit_clause] ";"
select_list: "*" | column ("," column)*
column: agg | NAME
agg: ("COUNT" | "SUM" | "AVG" | "MIN" | "MAX") "(" agg_arg ")"
agg_arg: "*" | NAME
where_clause: "WHERE" cond
cond: pred (("AND" | "OR") pred)*
pred: NAME cmp_op value
cmp_op: "=" | "<" | ">" | "<=" | ">=" | "!="
value: NUMBER | STRING | NAME
order_clause: "ORDER" "BY" NAME ["ASC" | "DESC"]
limit_clause: "LIMIT" NUMBER

NAME: /[a-z_][a-z0-9_]*/
NUMBER: /-?[0-9]+(\.[0-9]+)?/
STRING: /'[^'\n]*'/
WS: /[ \t\n]+/
%ignore WS
"""

MINILANG = r"""
// The GPL stand-in: a tiny imperative language with braced blocks,
// keywords that lex-overlap the NAME terminal (keyword-vs-identifier
// maximal munch), and multi-byte operators ("<=" etc.).
start: stmt stmt*
stmt: "let" NAME "=" expr ";"
    | NAME "=" expr ";"
    | "if" "(" expr ")" block ["else" block]
    | "while" "(" expr ")" block
    | "return" expr ";"
    | "print" "(" expr ")" ";"
block: "{" stmt* "}"
expr: sum [("<" | ">" | "<=" | ">=" | "==" | "!=") sum]
sum: prod (("+" | "-") prod)*
prod: atom (("*" | "/") atom)*
atom: INT | NAME | "(" expr ")"

NAME: /[a-z_][a-z0-9_]*/
INT: /[0-9]+/
WS: /[ \t\n]+/
%ignore WS
"""

JSONMSG = r"""
// Schema-constrained COMPACT JSON records (tool-call / extraction
// shaped, machine-canonical: no whitespace): the object keys are
// grammar literals and the leaf terminals are bounded, so large runs of
// the output are grammar-DETERMINED — the workload where jump-forward
// speculation shines (braces, quotes, keys, separators all forced; only
// ids/ops/args are model choices).
start: "[" record ("," record)* "]"
record: "{" KID ":" NUMBER "," KOP ":" OP "," KARGS ":" "[" [ARG ("," ARG)*] "]" "}"

KID.2: /"id"/
KOP.2: /"op"/
KARGS.2: /"args"/
OP.2: /"(get|set|del|add|list|ping)"/
ARG: /"[a-z0-9_]{1,8}"/
NUMBER: /[0-9]{1,4}/
"""

PYTHON_MINI = r"""
// A real-language target: a Python subset with layout-sensitive lexing
// (%indent). Designed so that anything the masked decoder completes is
// ast.parse()-able CPython:
//   * assignment targets are NAME only (keeps the grammar LALR(1): '='
//     appears nowhere else, '==' is the comparison operator);
//   * 'return' is only reachable inside function suites (fstmt/fsuite
//     mirror stmt/suite) — no return-outside-function SyntaxError;
//   * non-grammar Python keywords are claimed by RESERVED (priority 2,
//     referenced by an unreachable rule so it joins the lexer DFA) —
//     'break = 1' is a lex-level dead end, not a generated program;
//   * integer literals ban leading zeros; string escapes are a safe
//     subset valid in str AND bytes literals; strings/comments are
//     printable-ASCII, and no terminal matches TAB or CR, so the
//     byte-level column count always agrees with CPython's tokenizer.
start: program
program: stmt*

stmt: simple_stmt
    | "if" test ":" suite ("elif" test ":" suite)* ["else" ":" suite]
    | "while" test ":" suite
    | "for" NAME "in" test ":" suite
    | func_def
    | class_def

fstmt: fsimple_stmt
    | "if" test ":" fsuite ("elif" test ":" fsuite)* ["else" ":" fsuite]
    | "while" test ":" fsuite
    | "for" NAME "in" test ":" fsuite
    | func_def
    | class_def

simple_stmt: small_stmt NEWLINE
fsimple_stmt: small_stmt NEWLINE | "return" [test] NEWLINE
small_stmt: expr_stmt | "pass"
expr_stmt: test | NAME "=" test

func_def: "def" NAME "(" [params] ")" ":" fsuite
params: NAME ("," NAME)*
class_def: "class" NAME ["(" [args] ")"] ":" suite

suite: simple_stmt | NEWLINE INDENT stmt+ DEDENT
fsuite: fsimple_stmt | NEWLINE INDENT fstmt+ DEDENT

test: or_test
or_test: and_test ("or" and_test)*
and_test: not_test ("and" not_test)*
not_test: "not" not_test | comparison
comparison: arith (comp_op arith)*
comp_op: "==" | "!=" | "<" | ">" | "<=" | ">=" | "in" | "not" "in" | "is" | "is" "not"
arith: term (("+" | "-") term)*
term: factor (("*" | "/" | "//" | "%") factor)*
factor: "+" factor | "-" factor | power
power: atom_expr ["**" factor]
atom_expr: atom trailer*
trailer: "(" [args] ")" | "[" test "]" | "." NAME
args: test ("," test)*
atom: NAME | NUMBER | STRING | "True" | "False" | "None"
    | "(" test ")" | "[" [args] "]"

// unreachable: exists only so RESERVED participates in the lexer DFA
reserved_unreachable: RESERVED

NAME: /[A-Za-z_][A-Za-z0-9_]*/
RESERVED.2: /as|assert|async|await|break|continue|del|except|finally|from|global|import|lambda|nonlocal|raise|try|with|yield/
NUMBER: /(0|[1-9][0-9]*)([eE][+-]?[0-9]+)?|[0-9]+\.[0-9]*([eE][+-]?[0-9]+)?|\.[0-9]+([eE][+-]?[0-9]+)?/
STRING: /(r|R|b|B|u|U|rb|rB|Rb|RB|br|bR|Br|BR)?("(\\[\\'"nrtfvab0]|[ !#-\[\]-~])*"|'(\\[\\'"nrtfvab0]|[ -&(-\[\]-~])*')/
NEWLINE: /(\n[ ]*|#[ -~]*)+/
WS: / +/
LINE_CONT: /\\\n[ ]*/

%indent NEWLINE INDENT DEDENT
%ignore WS
%ignore LINE_CONT
"""

EMBEDDED: dict[str, str] = {
    "json": JSON,
    "calc": CALC,
    "sql": SQL,
    "minilang": MINILANG,
    "jsonmsg": JSONMSG,
    "python_mini": PYTHON_MINI,
}
