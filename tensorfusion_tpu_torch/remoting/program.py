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
"""

from __future__ import annotations

import io
import json
import re
import zipfile
from typing import Callable, List, Sequence, Tuple

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


def export_program(fn: Callable, specs: Sequence[Tuple[tuple, torch.dtype]],
                   treedef) -> Tuple[bytes, object, List[Tuple[tuple, torch.dtype]]]:
    """Export ``fn`` at the flat signature ``specs`` ((shape, dtype) per
    leaf of the arguments, whose structure is ``treedef``).  Returns
    (blob, the result's treedef, (shape, dtype) per result leaf)."""
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
    buf = io.BytesIO()
    torch.export.save(ep, buf)
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


def check_archive(blob: bytes) -> None:
    """Raise ``ValueError`` unless ``blob`` is an archive that
    ``torch.export.load`` reads without unpickling anything and whose
    graph calls only allowed targets.  Registers the port's custom
    operators first (the flash kernel's ``tpf_torch::flash_attn_fwd``)."""
    from .. import ops  # noqa: F401 - registers tpf_torch:: before the check

    try:
        zf = zipfile.ZipFile(io.BytesIO(blob))
        infos = zf.infolist()
    except (zipfile.BadZipFile, ValueError) as e:
        raise ValueError(f"program is not a torch.export archive: {e}") from None
    if not infos:
        raise ValueError("program archive is empty")
    root = infos[0].filename.split("/", 1)[0]
    raw_ok, payloads, models = set(), set(), []
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


def load_program(blob: bytes, device: torch.device) -> Callable:
    """Check, load and move a program to ``device``; returns the module
    (flat tensors in, a tuple of flat tensors out)."""
    from torch.export.passes import move_to_device_pass

    check_archive(blob)
    ep = torch.export.load(io.BytesIO(blob))
    return move_to_device_pass(ep, str(device)).module()
