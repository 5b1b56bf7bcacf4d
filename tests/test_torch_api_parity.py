"""The port is a drop-in for the JAX package below module level.

``tests/test_torch_import.py`` holds the port to every module and public
top-level name of ``upsp_tpu``.  This test walks both packages' ASTs one
level deeper, one case per JAX module (the Pallas modules excepted):

- every public class has in the port every public method, property,
  annotated field and attribute its ``__init__`` sets on ``self``;
- every public function and public method (``__init__`` and ``__call__``
  included) has every JAX parameter name in the port, and the leading
  parameters without defaults come in JAX's positional order;
- every JAX default is the port's, after a fixed mapping: ``jnp.<dtype>``
  is ``torch.<dtype>``, and a name of a module constant (``EPSILON``,
  ``MAX_ITERS``, ``PLATE[0]``) is its value.

What differs is listed in two tables, each entry with its reason:
``RENAMED`` (the port's batched names) and ``BY_DESIGN`` (the rest).  Return
arity and results are the behaviour tests' (``tests/test_torch_drop_in.py``).
"""

import ast
import glob
import os

import pytest

from test_torch_import import PALLAS_MODULES, REPO, UNPORTED_BY_DESIGN

BATCH = ("the port's idiom: the function takes a leading batch axis, so the "
         "argument is a batch")

# (module, qualified name) -> ({JAX parameter: port parameter}, reason)
RENAMED = {
    ("ops/fftreg.py", "correlate"): ({"img": "imgs"}, BATCH),
    ("ops/patching.py", "apply_patches"): ({"frame": "frames"}, BATCH),
    ("ops/projection.py", "project_frame"): ({"frame": "frames"}, BATCH),
    ("ops/registration.py", "warp_affine"): ({"img": "imgs", "warp": "warps"}, BATCH),
    ("ops/warp.py", "warp_validity_mask"): ({"warp": "warps"}, BATCH),
    ("ops/warp.py", "downsample2"): ({"img": "imgs"}, BATCH),
    ("ops/warp.py", "integer_shift"): ({"img": "imgs"}, BATCH),
    ("ops/warp.py", "scale_warp"): ({"warp": "warps"}, BATCH),
    ("parallel/mesh.py", "global_transpose"): (
        {"intensity": "block"},
        "a rank passes its own (F/D, N) block of the intensity, not a global "
        "array sharded over the mesh"),
    ("pipeline/phase2.py", "run_phase2_sharded"): (
        {"intensity": "it_local"},
        "a rank passes its own node block of the intensity (what "
        "global_transpose returned), not a global sharded array"),
}

SHARDING = ("jax.sharding against torch.distributed: a JAX array carries its "
            "sharding over a device mesh, a torch rank holds its own block and "
            "is told the mesh (parallel/mesh.py)")
NO_SLOT_ORDER = ("K5 always writes model order, so there is no slot-order route "
                 "to choose (ROADMAP.md, 'port the contract')")
IN_GATHER_PLAN = "folded into K5's GatherPlan (ops/gather_kernels.py)"

# module -> qualified name -> {JAX parameter or member: reason}.  A listed
# parameter is exempt from the presence, position and default checks.
BY_DESIGN = {
    "camera/pnp.py": {
        "solve_pnp_ransac": {
            "key": "the port takes ``seed`` for an explicit torch.Generator, "
                   "not a JAX PRNG key"},
    },
    "ops/registration.py": {
        "ecc_affine": {
            "band": "the banded XLA warp oracle is not ported, by design: K2 has "
                    "no band limit (``make_chunk_processor(ecc_band=)`` raises "
                    "and says so)"},
    },
    "parallel/mesh.py": {
        "make_mesh": {"devices": SHARDING, "axis": SHARDING, "n_hosts": SHARDING},
        "fetch_global": {"a": SHARDING},
        "local_block": {"a": SHARDING},
    },
    "pipeline/phase1.py": {
        "make_chunk_processor": {"use_pallas": NO_SLOT_ORDER,
                                 "slab_gather": NO_SLOT_ORDER},
        "make_packed_chunk_processor": {"use_pallas": NO_SLOT_ORDER},
        "Phase1Params": {"combined_index": IN_GATHER_PLAN,
                         "combined_weight": IN_GATHER_PLAN,
                         "corr_nodes": IN_GATHER_PLAN},
    },
}

JAX_MODULES = sorted(
    os.path.relpath(p, os.path.join(REPO, "upsp_tpu"))
    for p in glob.glob(os.path.join(REPO, "upsp_tpu", "**", "*.py"), recursive=True)
    if os.path.relpath(p, os.path.join(REPO, "upsp_tpu")) not in PALLAS_MODULES)


def _parse(path):
    with open(path) as fh:
        return ast.parse(fh.read())


def _constants(tree):
    """The module's top-level names bound to literals."""
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = value
            elif isinstance(t, ast.Tuple) and isinstance(value, tuple):
                out.update((e.id, v) for e, v in zip(t.elts, value)
                           if isinstance(e, ast.Name))
    return out


def _value(node, consts):
    """A default's value under the fixed mapping: literals, module
    constants (and their items), ``jnp.``/``torch.`` dtypes as
    ``dtype:<name>``; anything else its source text."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id]
    if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
            and node.value.id in consts and isinstance(node.slice, ast.Constant)):
        return consts[node.value.id][node.slice.value]
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id in ("jnp", "torch")):
        return "dtype:" + node.attr
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_value(node.operand, consts)
    if isinstance(node, ast.Tuple):
        return tuple(_value(e, consts) for e in node.elts)
    return ast.unparse(node)


_NO_DEFAULT = object()


def _params(fn, method):
    """[(name, default node or _NO_DEFAULT, positional)] without the
    bound first parameter of a method."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [_NO_DEFAULT] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, d, True) for p, d in zip(pos, defaults)]
    out += [(p.arg, _NO_DEFAULT if d is None else d, False)
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    static = any(isinstance(d, ast.Name) and d.id == "staticmethod"
                 for d in fn.decorator_list)
    return out[1:] if method and not static else out


def _is_property(fn):
    return any((isinstance(d, ast.Name) and d.id in ("property", "cached_property"))
               or (isinstance(d, ast.Attribute) and d.attr == "cached_property")
               for d in fn.decorator_list)


def _members(cls):
    """name -> (kind, node): methods, properties, annotated fields, class
    attributes and the attributes ``__init__`` sets on ``self``."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("property" if _is_property(node) else "method", node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out[node.target.id] = ("field", node)
        elif isinstance(node, ast.Assign):
            out.update((t.id, ("field", node)) for t in node.targets
                       if isinstance(t, ast.Name))
    init = out.get("__init__")
    if init is not None:
        for node in ast.walk(init[1]):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AnnAssign) else [])
            for t in targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out.setdefault(t.attr, ("attribute", None))
    return out


def _field_value(node):
    """A class-level field's default (None when it has none)."""
    return getattr(node, "value", None) if node is not None else None


def _public(name):
    return not name.startswith("_") or name in ("__init__", "__call__")


def _top(tree):
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    classes = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    return fns, classes


def _check_function(problems, qual, jfn, pfn, jconsts, pconsts, renamed, exempt,
                    method=False):
    jp = [p for p in _params(jfn, method) if p[0] not in exempt]
    pp = _params(pfn, method)
    port = {name: (d, pos) for name, d, pos in pp}
    has_kwargs = pfn.args.kwarg is not None
    for name, jd, _ in jp:
        pname = renamed.get(name, name)
        if pname not in port:
            problems.append(f"{qual}: no parameter {pname!r}"
                            + (" (only through **kwargs)" if has_kwargs else ""))
            continue
        if jd is _NO_DEFAULT:
            continue
        pd = port[pname][0]
        if pd is _NO_DEFAULT:
            problems.append(f"{qual}({pname}): JAX default {ast.unparse(jd)}, "
                            "the port's none")
        elif _value(jd, jconsts) != _value(pd, pconsts):
            problems.append(f"{qual}({pname}): JAX default {ast.unparse(jd)}, "
                            f"the port's {ast.unparse(pd)}")
    lead = [renamed.get(n, n) for n, d, pos in jp if pos and d is _NO_DEFAULT]
    ppos = [n for n, _, pos in pp if pos]
    if ppos[:len(lead)] != lead:
        problems.append(f"{qual}: leading positional {lead}, the port's "
                        f"{ppos[:len(lead)]}")


def _problems(module):
    jtree = _parse(os.path.join(REPO, "upsp_tpu", module))
    ptree = _parse(os.path.join(REPO, "upsp_tpu_torch", module))
    jconsts, pconsts = _constants(jtree), _constants(ptree)
    jfns, jclasses = _top(jtree)
    pfns, pclasses = _top(ptree)
    design = BY_DESIGN.get(module, {})
    problems = []

    def check(qual, jfn, pfn, method=False):
        renamed = RENAMED.get((module, qual), ({}, ""))[0]
        _check_function(problems, qual, jfn, pfn, jconsts, pconsts, renamed,
                        design.get(qual, {}), method)

    for name, jfn in jfns.items():
        if _public(name) and name in pfns:
            check(name, jfn, pfns[name])
    for name, jcls in jclasses.items():
        if not _public(name) or name in UNPORTED_BY_DESIGN.get(module, {}):
            continue
        if name not in pclasses:
            problems.append(f"class {name} missing")
            continue
        jm, pm = _members(jcls), _members(pclasses[name])
        exempt = design.get(name, {})
        for member, (kind, node) in jm.items():
            if not _public(member) or member in exempt:
                continue
            if member not in pm:
                problems.append(f"{name}.{member}: {kind} missing")
                continue
            pkind, pnode = pm[member]
            if kind == "method":
                if pkind != "method":
                    problems.append(f"{name}.{member}: a method in JAX, a "
                                    f"{pkind} in the port")
                else:
                    check(f"{name}.{member}", node, pnode, method=True)
            elif pkind == "method":
                problems.append(f"{name}.{member}: a {kind} in JAX, a method "
                                "in the port")
            elif _field_value(node) is not None:
                jd, pd = _field_value(node), _field_value(pnode)
                if pd is None or _value(jd, jconsts) != _value(pd, pconsts):
                    problems.append(
                        f"{name}.{member}: JAX default {ast.unparse(jd)}, the "
                        f"port's {'none' if pd is None else ast.unparse(pd)}")
    return problems


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_matches_jax_signatures(module):
    """Classes' members, functions' parameters, their leading positional
    order and defaults, as the module docstring says."""
    assert _problems(module) == []


def test_tables_name_real_differences():
    """Every entry of RENAMED and BY_DESIGN carries a reason and names a
    parameter or member that exists in the JAX package, so an entry the
    port no longer needs shows."""
    for (module, qual), (mapping, reason) in RENAMED.items():
        assert reason and mapping, (module, qual)
        _assert_jax_names(module, qual, mapping)
    for module, table in BY_DESIGN.items():
        for qual, items in table.items():
            assert items and all(items.values()), (module, qual)
            _assert_jax_names(module, qual, items)


def _assert_jax_names(module, qual, names):
    jfns, jclasses = _top(_parse(os.path.join(REPO, "upsp_tpu", module)))
    if "." in qual:
        cls, member = qual.split(".")
        have = {p[0] for p in _params(_members(jclasses[cls])[member][1], True)}
    elif qual in jclasses:
        have = set(_members(jclasses[qual]))
    else:
        have = {p[0] for p in _params(jfns[qual], False)}
    assert set(names) <= have, (module, qual, set(names) - have)
