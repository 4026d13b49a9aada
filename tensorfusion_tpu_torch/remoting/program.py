"""The program format of remote execution: a ``torch.export`` archive,
in place of the reference's serialized ``jax.export``.

Client side, :func:`export_program` traces ``fn`` over fake CPU tensors
of the call's signature (no device and no data are needed) into an
``ExportedProgram`` whose inputs and outputs are the flat tensor leaves
of the call, and writes it with ``torch.export.save``.  The archive is
made canonical so that two exports of one function at one signature
give the same bytes, and so the same executable id (the sha256 of the
blob): node stack traces (source paths) and the example inputs (the
fake tensors) are left out.

Worker side, :func:`load_program` takes the blob from an untrusted peer.
``torch.export.load`` unpickles parts of an archive with arbitrary-code
loading (pickled weights and constants, and the example inputs when the
safe load of them fails) and resolves node targets by name from the
``torch`` module, so the archive is checked first: every member must be
stored uncompressed and be one the format names; example inputs must be
empty; every weight and constant must be a raw tensor payload, never a
pickle; and every node (and every operator passed as an argument) must
call an operator of a closed set written in this file: an ``aten`` /
``prims`` overload tagged ``torch.Tag.core`` or on the short list of
non-core overloads that ``torch.export`` emits for the port's own
programs (:data:`_NONCORE_OPS`), minus every op with an effect outside
the program (file I/O, printing, process-wide cuFFT state, stream
bookkeeping, the process's random generator, unchecked indexing,
uninitialized allocation, storage swaps); a ``tpf_torch`` operator; one
of the control-flow higher-order operators export emits; or one of a
few ``operator`` / ``math`` functions.  Anything else raises
``ValueError`` before a byte of it is deserialized.  The program is then
moved to the worker's device (``move_to_device_pass``: an export on the
CPU bakes ``device="cpu"`` into the tensors the graph makes, such as
RoPE's positions) and returned as a callable module.

A sharded program (protocol v3): ``torch.export`` keeps no in/out
shardings the way ``jax.export`` does, so :func:`export_program` writes
them beside the program, as the archive's one extra member
``extra/shardings.json``: ``nr_devices``, a spec per flat input and per
flat output in the reference's ``PartitionSpec`` form over one flat
mesh axis (``None`` replicated; else a list of ``None`` or the axis
name, one entry per leading dimension, at most one named), and the
shapes they apply to.  The member is part of the blob, so the
executable id covers it.  :func:`check_archive` refuses specs that do
not fit their shapes (a named dimension must split evenly over
``nr_devices``) and :func:`load_program` shapes that are not the
program's own.
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

#: ``operator`` / ``math`` functions a graph may call (shape arithmetic
#: and tuple indexing); every other target must be a torch operator
_OPERATOR_TARGETS = frozenset((
    "getitem", "add", "sub", "mul", "truediv", "floordiv", "mod", "neg",
    "pos", "abs", "pow", "eq", "ne", "lt", "le", "gt", "ge", "and_",
    "or_", "xor", "not_"))
_MATH_TARGETS = frozenset(("ceil", "floor", "trunc", "sqrt"))
#: operator namespaces a graph may call: ATen, its primitives and the
#: port's kernels (``tpf_torch``); never another library's in the process
_NAMESPACES = frozenset(("aten", "prims", "tpf_torch"))
#: the ``aten`` overloads outside ``torch.Tag.core`` that a program may
#: call: those ``torch.export`` emits for the functions the port ships
#: (the Llama forward with ``attn_impl`` "flash" and "full", its decoder
#: layer step, chip_smoke.py's last-position forward, in f32 and bf16,
#: and the tests' programs), found by exporting them; every other
#: non-core overload is refused
_NONCORE_OPS = frozenset((
    "_assert_tensor_metadata.default", "arange.default", "einsum.default",
    "linear.default", "masked_fill.Scalar", "matmul.default", "max.default",
    "ones.default", "repeat_interleave.self_int", "reshape.default",
    "softmax.int", "square.default", "stack.default", "sum.default",
    "to.dtype", "transpose.int", "tril.default"))
#: the higher-order operators export emits for control flow and for
#: grad / autocast regions (their subgraphs are checked like the graph)
_HIGHER_ORDER = frozenset(("cond", "while_loop", "map_impl", "scan",
                           "wrap_with_set_grad_enabled",
                           "wrap_with_autocast"))

_NAME = r"[A-Za-z0-9_]+"
_METADATA = frozenset(("archive_format", "archive_version", "byteorder",
                       ".data/version", ".data/serialization_id"))
_MODEL = re.compile(rf"models/{_NAME}\.json")
_SAMPLE_INPUTS = re.compile(rf"data/sample_inputs/{_NAME}\.pt")
_CONFIG = re.compile(rf"data/(weights|constants)/{_NAME}_config\.json")
_PAYLOAD = re.compile(rf"data/(weights|constants)/({_NAME})")
#: the sharded program's specs (the one extra member an archive may hold)
SHARDINGS = "shardings.json"
#: ceiling on ``nr_devices``: it arrives off the wire
MAX_DEVICES = 64

Spec = Optional[Tuple[Optional[str], ...]]


class _Flat(torch.nn.Module):
    """``fn`` over the flat leaves of its arguments, returning the flat
    leaves of its result (so neither side needs the other's pytrees)."""

    def __init__(self, fn: Callable, treedef):
        super().__init__()
        self.fn = fn
        self.treedef = treedef

    def forward(self, *flat):
        out = self.fn(*pytree.tree_unflatten(list(flat), self.treedef))
        return tuple(pytree.tree_leaves(out))


def is_spec(x) -> bool:
    """A ``PartitionSpec`` of the flat mesh: None, or a tuple (or list) of
    None and axis names."""
    return x is None or (isinstance(x, (tuple, list))
                         and all(e is None or isinstance(e, str) for e in x))


def flat_specs(specs, treedef) -> List[Spec]:
    """One spec per leaf of a pytree of structure ``treedef``: ``specs``
    is one spec for every leaf, or one per top-level child (each applying
    to every leaf of that child)."""
    if is_spec(specs):
        return [None if specs is None else tuple(specs)] * treedef.num_leaves
    # each top-level child's leaves, by their flat positions
    children = pytree.tree_unflatten(list(range(treedef.num_leaves)), treedef)
    if len(specs) != len(children):
        raise ValueError(f"{len(specs)} specs for {len(children)} arguments")
    out: List[Spec] = [None] * treedef.num_leaves
    for spec, child in zip(specs, children):
        if not is_spec(spec):
            raise ValueError(f"not a PartitionSpec of one mesh axis: {spec!r}")
        for i in pytree.tree_leaves(child):
            out[i] = None if spec is None else tuple(spec)
    return out


def spec_dim(spec: Spec) -> Optional[int]:
    """The dimension a spec splits, or None when it replicates."""
    named = [i for i, e in enumerate(spec or ()) if e is not None]
    return named[0] if named else None


def _check_spec(spec, shape, n: int, what: str) -> None:
    if spec is None:
        return
    if not isinstance(spec, list) or not all(e is None or isinstance(e, str)
                                             for e in spec):
        raise ValueError(f"{what}: spec {spec!r} is not a PartitionSpec")
    named = [(i, e) for i, e in enumerate(spec) if e is not None]
    if len(spec) > len(shape) or len(named) > 1:
        raise ValueError(f"{what}: spec {spec} does not fit shape {list(shape)} "
                         f"over one flat mesh axis")
    if named and shape[named[0][0]] % n:
        raise ValueError(f"{what}: dim {named[0][0]} of {list(shape)} does not "
                         f"split over {n} devices")


def check_shardings(shardings: Dict[str, Any]) -> Dict[str, Any]:
    """Validate a sharded program's ``shardings.json`` (off the wire);
    returns it."""
    try:
        n = shardings["nr_devices"]
        pairs = [(shardings["in_specs"], shardings["in_shapes"], "input"),
                 (shardings["out_specs"], shardings["out_shapes"], "output")]
    except (KeyError, TypeError):
        raise ValueError("program shardings lack nr_devices, specs or shapes") from None
    if not isinstance(n, int) or not 2 <= n <= MAX_DEVICES:
        raise ValueError(f"program shardings: nr_devices {n!r} not in 2..{MAX_DEVICES}")
    axes = set()
    for specs, shapes, what in pairs:
        if not isinstance(specs, list) or not isinstance(shapes, list) or \
                len(specs) != len(shapes):
            raise ValueError(f"program shardings: {what} specs and shapes differ "
                             f"in number")
        for i, (spec, shape) in enumerate(zip(specs, shapes)):
            if not isinstance(shape, list) or not all(
                    isinstance(d, int) and d >= 0 for d in shape):
                raise ValueError(f"program shardings: {what} {i} shape {shape!r}")
            _check_spec(spec, shape, n, f"{what} {i}")
            axes |= {e for e in spec or () if e is not None}
    if len(axes) > 1:
        raise ValueError(f"program shardings name {sorted(axes)}: one flat mesh "
                         f"axis only")
    return shardings


def export_program(fn: Callable, specs: Sequence[Tuple[tuple, torch.dtype]],
                   treedef, in_specs=None, out_specs=None, nr_devices: int = 1
                   ) -> Tuple[bytes, object, List[Tuple[tuple, torch.dtype]]]:
    """Export ``fn`` at the flat signature ``specs`` ((shape, dtype) per
    leaf of the arguments, whose structure is ``treedef``).  Returns
    (blob, the result's treedef, (shape, dtype) per result leaf).

    With ``nr_devices`` > 1 the program is sharded: ``in_specs`` (one
    spec, or one per argument) and ``out_specs`` (one spec, or one per
    result leaf) go into the archive's ``shardings.json``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # non-fake inputs allowed: an nn.Module's own parameters are real
    with FakeTensorMode(allow_non_fake_inputs=True):
        fakes = [torch.empty(shape, dtype=dtype) for shape, dtype in specs]
        out_leaves, out_tree = pytree.tree_flatten(
            fn(*pytree.tree_unflatten(list(fakes), treedef)))
        out_sigs = [(tuple(l.shape), l.dtype) for l in out_leaves]
        ep = torch.export.export(_Flat(fn, treedef), tuple(fakes),
                                 strict=False)
    for gm in ep.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)
    ep.example_inputs = None
    extra = None
    if nr_devices > 1:
        outs = [None if out_specs is None else tuple(out_specs)] * len(out_sigs) \
            if is_spec(out_specs) else [None if s is None else tuple(s)
                                        for s in out_specs]
        if len(outs) != len(out_sigs):
            raise ValueError(f"{len(outs)} out_specs for {len(out_sigs)} results")
        shardings = check_shardings({
            "nr_devices": int(nr_devices),
            "in_specs": [None if s is None else list(s)
                         for s in flat_specs(in_specs, treedef)],
            "in_shapes": [list(shape) for shape, _ in specs],
            "out_specs": [None if s is None else list(s) for s in outs],
            "out_shapes": [list(shape) for shape, _ in out_sigs]})
        extra = {SHARDINGS: json.dumps(shardings, sort_keys=True)}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files=extra)
    return buf.getvalue(), out_tree, out_sigs


def _refused_op(name: str, op) -> bool:
    """Operators that a tenant's program may not call, whatever their
    tags: file I/O (``from_file``), printing to the worker's output
    (``_print``), process-wide state every tenant shares (``_cufft_*``
    plan caches, ``record_stream``, and every op that draws from the
    process's random generator), indexing and views without bounds
    checks (``*unsafe*``, ``_nested_view_from_buffer*``), storage swaps
    (a ``Storage`` argument), and memory handed back uninitialized
    (``empty*``, ``resize*``: it may hold another tenant's freed
    buffers)."""
    if name in ("from_file", "_print", "record_stream") or \
            "unsafe" in name or "empty" in name or name.startswith(
                ("_nested_view_from_buffer", "resize", "_cufft")) or \
            torch.Tag.nondeterministic_seeded in op.tags:
        return True
    for arg in op._schema.arguments:
        kind = str(arg.type)
        if "Storage" in kind or ("str" in kind and any(
                w in arg.name.lower() for w in ("file", "path"))):
            return True
    return False


def _allowed_target(target: str) -> bool:
    head, _, rest = target.partition(".")
    if head == "_operator":
        return rest in _OPERATOR_TARGETS
    if head == "math":
        return rest in _MATH_TARGETS
    parts = target.split(".")
    if parts[:2] != ["torch", "ops"]:
        return False
    if len(parts) == 4 and parts[2] == "higher_order":
        return parts[3] in _HIGHER_ORDER
    if len(parts) != 5 or parts[2] not in _NAMESPACES or \
            any(p.startswith("__") for p in parts):
        return False
    try:
        op = getattr(getattr(getattr(torch.ops, parts[2]), parts[3]), parts[4])
    except (AttributeError, RuntimeError):
        return False
    if not isinstance(op, torch._ops.OpOverload) or _refused_op(parts[3], op):
        return False
    # the closed set: core ATen, the listed overloads, the port's kernels
    return parts[2] == "tpf_torch" or torch.Tag.core in op.tags or (
        parts[2] == "aten" and f"{parts[3]}.{parts[4]}" in _NONCORE_OPS)


def _node_targets(tree, out: set) -> set:
    """Every name a serialized program resolves to a callable: each graph
    node's ``target`` (nodes are the dicts with ``target`` and
    ``inputs``; subgraphs included) and each operator passed as an
    argument (``as_operator``)."""
    if isinstance(tree, dict):
        if isinstance(tree.get("target"), str) and "inputs" in tree:
            out.add(tree["target"])
        if isinstance(tree.get("as_operator"), str):
            out.add(tree["as_operator"])
        for v in tree.values():
            _node_targets(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _node_targets(v, out)
    return out


def check_archive(blob: bytes) -> Optional[Dict[str, Any]]:
    """Raise ``ValueError`` unless ``blob`` is an archive that
    ``torch.export.load`` reads without unpickling anything and whose
    graph calls only allowed targets.  Registers the port's custom
    operators first (the flash kernel's ``tpf_torch::flash_attn_fwd``).
    Returns a sharded program's checked shardings, else None."""
    from .. import ops  # noqa: F401 - registers tpf_torch:: before the check

    try:
        zf = zipfile.ZipFile(io.BytesIO(blob))
        infos = zf.infolist()
    except (zipfile.BadZipFile, ValueError) as e:
        raise ValueError(f"program is not a torch.export archive: {e}") from None
    if not infos:
        raise ValueError("program archive is empty")
    root = infos[0].filename.split("/", 1)[0]
    raw_ok, payloads, models, shardings = set(), set(), [], None
    for info in infos:
        prefix, _, name = info.filename.partition("/")
        if prefix != root or not name:
            raise ValueError(f"program archive member {info.filename!r} "
                             f"outside {root}/")
        if info.compress_type != zipfile.ZIP_STORED:
            raise ValueError(f"program archive member {name} is compressed")
        if name in _METADATA:
            continue
        if _MODEL.fullmatch(name):
            models.append(info.filename)
        elif _SAMPLE_INPUTS.fullmatch(name):
            if info.file_size:
                raise ValueError("program archive carries example inputs "
                                 "(a pickle); export without them")
        elif _CONFIG.fullmatch(name):
            kind = _CONFIG.fullmatch(name).group(1)
            try:
                config = json.loads(zf.read(info)).get("config", {})
            except (ValueError, AttributeError) as e:
                raise ValueError(f"program archive {name}: {e}") from None
            for fqn, entry in config.items():
                if not isinstance(entry, dict) or entry.get("use_pickle") is not False:
                    raise ValueError(f"program archive {kind} entry {fqn!r} is "
                                     f"not a raw tensor (pickled payloads are "
                                     f"refused)")
                raw_ok.add(f"data/{kind}/{entry.get('path_name')}")
        elif _PAYLOAD.fullmatch(name):
            payloads.add(name)
        elif name == "extra/" + SHARDINGS:
            try:
                shardings = check_shardings(json.loads(zf.read(info)))
            except (ValueError, TypeError) as e:
                raise ValueError(f"program archive {name}: {e}") from None
        else:
            raise ValueError(f"program archive member {name} is not part of "
                             f"the program format")
    if payloads - raw_ok:
        raise ValueError(f"program archive members {sorted(payloads - raw_ok)} "
                         f"are not raw tensors of its configs")
    if len(models) != 1:
        raise ValueError(f"program archive holds {len(models)} programs, not 1")
    try:
        program = json.loads(zf.read(models[0]))
    except ValueError as e:
        raise ValueError(f"program archive model: {e}") from None
    bad = sorted(t for t in _node_targets(program, set())
                 if not _allowed_target(t))
    if bad:
        raise ValueError(f"program calls targets a tenant may not: {bad[:5]}")
    return shardings


def _user_shapes(ep) -> Tuple[List[list], List[list]]:
    """The global shapes of a program's flat inputs and outputs."""
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [list(nodes[name].meta["val"].shape)
           for name in ep.graph_signature.user_inputs]
    out_node = next(n for n in ep.graph.nodes if n.op == "output")
    outs = [list(a.meta["val"].shape) for a in out_node.args[0]
            if isinstance(a, torch.fx.Node)]
    return ins, outs


def load_program(blob: bytes, device: torch.device
                 ) -> Tuple[Callable, Optional[Dict[str, Any]]]:
    """Check, load and move a program to ``device``; returns the module
    (flat tensors in, a tuple of flat tensors out) and, for a sharded
    program, its checked shardings."""
    from torch.export.passes import move_to_device_pass

    shardings = check_archive(blob)
    ep = torch.export.load(io.BytesIO(blob))
    if shardings is not None and _user_shapes(ep) != (
            shardings["in_shapes"], shardings["out_shapes"]):
        raise ValueError(f"program shardings name shapes {shardings['in_shapes']} -> "
                         f"{shardings['out_shapes']}, the program's are "
                         f"{_user_shapes(ep)}")
    return move_to_device_pass(ep, str(device)).module(), shardings
