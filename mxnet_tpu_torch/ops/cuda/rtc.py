"""Runtime-compiled Rtc kernels on the card: the compile cache and the launch.

The port's counterpart of ``mxnet_tpu/rtc.py:Rtc._build`` (the Pallas call
at :65). :func:`rtc_launch` takes a checked body
(:class:`~.rtc_codegen.Program`) and the input tensors on one CUDA card,
lays out the index space (:func:`~.rtc_codegen.layout`: dims of size 1
dropped, dims every operand steps through as one merged), has
:mod:`.rtc_codegen` write the kernel, compiles it with NVRTC through
``csrc/rtc_runtime.cu`` at its first use, and launches it on torch's
current stream into fresh output tensors. Inputs that are not contiguous
(views, broadcast ``expand``s) are read in place through their strides,
which are launch arguments; so are the sizes. The compiled module is keyed
by the generated source, which holds the body, the dtypes, the rank of the
collapsed index space and each operand's access kind, so two bodies that
differ only in a dtype compile twice, and the SGD body over the
transformer's 7 parameter shapes (all contiguous, so all of rank 1)
compiles once. Where every read is contiguous or one broadcast element,
the module also holds a vector kernel (16-byte accesses, the scalar loop
as its tail, a default grid that covers n in one pass); each push takes it
when its pointers are aligned for it (:func:`~.rtc_codegen.vector_aligned`,
checked per push since the plan is kept per layout, not per pointer) and
the scalar kernel otherwise, with the same bits either way. Launches are
counted in ``rtc_launch.launches``, the vector kernel's also in
``rtc_launch.vector_launches``. A program outside that elementwise
subset (``Program.simple`` false) compiles into one module of stages
(:func:`~.rtc_codegen.plan_stages`, :func:`~.rtc_codegen.emit_stages`):
its sizes are in the source, the inputs' strides are launch arguments,
values that cross stages go to scratch from ``torch.empty`` on the
current stream, and the stages launch in order, each counted in
``rtc_launch.launches`` and by kind in ``rtc_launch.stage_launches``. Map
stages take the caller's launch shape; reduce and product stages choose
their own. There is no fallback: a compile or launch that fails raises
:class:`MXNetError` with NVRTC's log or the driver's error.
"""
from __future__ import annotations

import ctypes
import math
import time
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ... import _build
from ...base import MXNetError
from ...dtypes import torch_dtype
from .rtc_codegen import (Program, buffer_spec, emit, emit_stages, layout,
                          plan_stages, vector_aligned, vector_kernel_name,
                          vector_width)

__all__ = ["rtc_launch", "compile_source", "check_launch_dims", "STATS",
           "ARCH"]

ARCH = "sm_90a"
THREADS = 256
# blocks per SM of the scalar kernel's default launch: 8 x 256 threads fill
# an SM, and a grid-stride loop covers the rest
BLOCKS_PER_SM = 8
_LOG_BYTES = 1 << 16


class CompiledKernel(NamedTuple):
    module: int
    function: int
    name: str
    seconds: float  # NVRTC compile plus module load
    log: str


# (source, device index) -> CompiledKernel
_CACHE: Dict[Tuple[str, int], CompiledKernel] = {}
# counts since import: modules compiled, compiled kernels reused (a
# source already compiled, or a layout already planned), compile seconds
STATS = {"compiles": 0, "cache_hits": 0, "compile_seconds": []}


def _lib():
    lib = _build.load("rtc_runtime")
    if lib.rtc_compile.argtypes is None:
        lib.rtc_compile.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_char_p, ctypes.c_size_t]
        lib.rtc_compile.restype = ctypes.c_int
        lib.rtc_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 6 + [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.rtc_launch.restype = ctypes.c_int
        lib.rtc_module_function.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.rtc_module_function.restype = ctypes.c_int
        lib.rtc_error_string.argtypes = [ctypes.c_int]
        lib.rtc_error_string.restype = ctypes.c_char_p
        lib.rtc_nvrtc_version.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.rtc_nvrtc_version.restype = ctypes.c_int
    return lib


def nvrtc_version() -> Tuple[int, int]:
    major, minor = ctypes.c_int(), ctypes.c_int()
    _lib().rtc_nvrtc_version(ctypes.byref(major), ctypes.byref(minor))
    return major.value, minor.value


def compile_source(source: str, kernel_name: str,
                   device_index: int) -> CompiledKernel:
    """The kernel ``kernel_name`` of ``source`` loaded on card
    ``device_index``, compiled by NVRTC for sm_90a at its first use."""
    key = (source, device_index)
    hit = _CACHE.get(key)
    if hit is not None:
        STATS["cache_hits"] += 1
        return hit
    lib = _lib()
    module, function = ctypes.c_void_p(), ctypes.c_void_p()
    log = ctypes.create_string_buffer(_LOG_BYTES)
    t0 = time.perf_counter()
    with torch.cuda.device(device_index):  # makes torch's context current
        err = lib.rtc_compile(source.encode(), kernel_name.encode(),
                              ARCH.encode(), device_index,
                              ctypes.byref(module), ctypes.byref(function),
                              log, _LOG_BYTES)
    seconds = time.perf_counter() - t0
    text = log.value.decode(errors="replace")
    if err != 0:
        raise MXNetError(
            f"Rtc: NVRTC compile of {kernel_name} for {ARCH} failed: "
            f"{lib.rtc_error_string(err).decode()} ({err})\n{text}\n"
            f"-- source --\n{source}")
    compiled = CompiledKernel(module.value, function.value, kernel_name,
                              seconds, text)
    _CACHE[key] = compiled
    STATS["compiles"] += 1
    STATS["compile_seconds"].append(seconds)
    return compiled


def check_launch_dims(grid_dims, block_dims):
    """(grid, block) as 3-tuples, or None for each left to the port.
    Raises MXNetError for a zero or negative dim, more than 1024 threads a
    block, or dims past CUDA's limits."""
    def three(dims, what):
        if dims is None:
            return None
        dims = tuple(int(d) for d in (dims if isinstance(dims, (tuple, list))
                                      else (dims,)))
        if not 1 <= len(dims) <= 3 or any(d <= 0 for d in dims):
            raise MXNetError(f"Rtc {what}_dims {dims}: one to three "
                             "positive sizes")
        return dims + (1,) * (3 - len(dims))
    grid, block = three(grid_dims, "grid"), three(block_dims, "block")
    if block is not None and (math.prod(block) > 1024 or block[2] > 64):
        raise MXNetError(f"Rtc block_dims {block}: a block holds at most 1024 "
                         "threads (z at most 64)")
    if grid is not None and (grid[0] >= 2 ** 31 or max(grid[1:]) > 65535):
        raise MXNetError(f"Rtc grid_dims {grid}: past CUDA's grid limits")
    return grid, block


def _span(t: torch.Tensor) -> int:
    return 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))


def module_function(kernel: CompiledKernel, name: str) -> int:
    """Kernel ``name`` of ``kernel``'s module."""
    function = ctypes.c_void_p()
    lib = _lib()
    err = lib.rtc_module_function(kernel.module, name.encode(),
                                  ctypes.byref(function))
    if err != 0:
        raise MXNetError(f"Rtc: no kernel {name} in the module of "
                         f"{kernel.name}: {lib.rtc_error_string(err).decode()}"
                         f" ({err})")
    return function.value


class _Plan(NamedTuple):
    kernel: CompiledKernel
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    params: ctypes.Array  # RtcArgs: n, the dims, the read Refs' strides
    vector: int  # the vector kernel, or 0 where the layout has none
    vector_grid: Tuple[int, int, int]
    flat: Tuple[int, ...]  # the reads the vector kernel loads in vectors
    access: Tuple[int, ...]  # bytes of a vector of each, then each output


def _plan(prog: Program, reads, device, grid, block) -> _Plan:
    """The kernels and launch arguments for this layout of the inputs: the
    translation and the compile happen once per layout, not per push."""
    n = math.prod(prog.shape)
    dims, strides, kinds = layout(prog.shape,
                                  [(t.shape, t.stride()) for t in reads])
    wide = n >= 2 ** 31 or any(_span(t) >= 2 ** 31 for t in reads)
    source, kname = emit(prog, len(dims), kinds, wide)
    kernel = compile_source(source, kname, device.index)
    vec = vector_width(prog, kinds)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    block = block or (THREADS, 1, 1)
    threads = math.prod(block)
    # the scalar kernel: one element a thread per iteration, at most
    # BLOCKS_PER_SM blocks an SM
    scalar_grid = grid or (min(-(-n // threads), sms * BLOCKS_PER_SM), 1, 1)
    vector, vector_grid, flat, access = 0, scalar_grid, (), ()
    if vec is not None:
        vector = module_function(kernel, vector_kernel_name(kname))
        # the vector kernel: a vector of vec elements a thread, over a grid
        # that covers n in one pass. Each SM holds as many blocks as its
        # registers allow (up to 2048 threads: 32 KB of each contiguous
        # operand in flight), a block that ends makes room for the next,
        # and no thread loops. On an H100 this ran the SGD body faster
        # than BLOCKS_PER_SM blocks an SM with a grid-stride loop
        # (chip_smoke.py phase 10; PERF.md)
        nvec = max(n // vec, 1)
        vector_grid = grid or (-(-nvec // threads), 1, 1)
        flat = tuple(k for k, kind in enumerate(kinds) if kind == "flat")
        access = tuple(vec * reads[k].element_size() for k in flat) + tuple(
            vec * torch_dtype(dt).itemsize
            for _, _, dt in prog.outputs)
    packed = [n, *dims, *(s for st in strides for s in st)]
    return _Plan(kernel, scalar_grid, block,
                 (ctypes.c_longlong * len(packed))(*packed), vector,
                 vector_grid, flat, access)


_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32,
          "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8,
          "bool": torch.bool}


class _StagedPlan(NamedTuple):
    kernel: CompiledKernel  # the module (its first stage's kernel)
    launches: Tuple[tuple, ...]  # (function, grid, block, kind) per kernel
    params: ctypes.Array  # RtcArgs: the inputs' strides
    scratch: Tuple[tuple, ...]  # (buffer, shape, dtype) of scratch buffers
    slots: int  # partial-sum slots of split reductions


def _staged_plan(prog: Program, inputs, device, grid, block) -> _StagedPlan:
    """The module and launches of a staged program for this layout of the
    inputs: the inputs' strides are launch arguments, so the module is
    compiled once per program and index width."""
    stages = getattr(prog, "stages", None)
    if stages is None:
        stages = prog.stages = plan_stages(prog)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sizes = [math.prod(buffer_spec(prog, b)[0]) for b in stages.buffers]
    wide = (max(sizes) >= 2 ** 31 or any(_span(t) >= 2 ** 31 for t in inputs))
    source, launches, slots = emit_stages(prog, stages, wide, sms)
    kernel = compile_source(source, launches[0][0], device.index)
    block = block or (THREADS, 1, 1)
    threads = math.prod(block)
    out = []
    for (name, g, b, kind), st in zip(launches, _stage_of(stages, launches)):
        function = kernel.function if name == kernel.name else \
            module_function(kernel, name)
        if kind == "map":
            n = math.prod(st.nodes[0].shape)
            g = grid or (min(-(-n // threads), sms * BLOCKS_PER_SM), 1, 1)
            b = block
        out.append((function, g, b, kind))
    maxr = max([len(s) for _, s, _ in prog.inputs] + [1])
    packed = []
    for t in inputs:
        st = list(t.stride()) + [0] * (maxr - t.dim())
        packed += st
    packed += [0] * (max(len(prog.inputs), 1) * maxr - len(packed))
    scratch = tuple((j, *buffer_spec(prog, b)) for j, b in
                    enumerate(stages.buffers) if b[0] == "scratch")
    return _StagedPlan(kernel, tuple(out),
                       (ctypes.c_longlong * len(packed))(*packed), scratch,
                       slots)


def _stage_of(stages, launches):
    """The stage of each launch (a split reduction's fold is its stage's)."""
    it = iter(stages.stages)
    st = None
    for name, *_ in launches:
        if not name.endswith("f"):
            st = next(it)
        yield st


def _staged_launch(prog: Program, inputs, device, grid, block):
    key = ("staged", device.index, grid, block,
           tuple((tuple(t.shape), t.stride()) for t in inputs))
    plan = prog.plans.get(key)
    if plan is None:
        plan = prog.plans[key] = _staged_plan(prog, inputs, device, grid,
                                              block)
    else:
        STATS["cache_hits"] += 1
    outputs = [torch.empty(s, dtype=_TORCH[dt], device=device)
               for _, s, dt in prog.outputs]
    buffers = {}
    for j, shape, dt in plan.scratch:
        buffers[j] = torch.empty(shape, dtype=_TORCH[dt], device=device)
    for j, b in enumerate(prog.stages.buffers):
        if b[0] == "out":
            buffers[j] = outputs[b[1]]
    part_f = torch.empty(max(plan.slots, 1), dtype=torch.float32,
                         device=device)
    part_i = torch.empty(max(plan.slots, 1), dtype=torch.int32, device=device)
    tensors = list(inputs) + [buffers[j] for j in range(len(buffers))] + [
        part_f, part_i]
    pointers = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    argv = (ctypes.c_void_p * (1 + len(pointers)))(
        ctypes.addressof(plan.params), *(ctypes.addressof(p) for p in pointers))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for function, g, b, kind in plan.launches:
            err = lib.rtc_launch(function, *g, *b, stream, argv)
            if err != 0:
                raise MXNetError(f"Rtc kernel {plan.kernel.name} ({kind} "
                                 f"stage) launch (grid {g}, block {b}) "
                                 f"failed: {lib.rtc_error_string(err).decode()}"
                                 f" ({err})")
            rtc_launch.launches += 1
            rtc_launch.stage_launches[kind] += 1
    return outputs


def rtc_launch(prog: Program, inputs: Sequence[torch.Tensor],
               grid_dims=None, block_dims=None,
               force_scalar: bool = False) -> List[torch.Tensor]:
    """Run ``prog`` on ``inputs`` (CUDA tensors on one card, in the Rtc's
    input order) and return its outputs as new tensors. Counts each kernel
    launch in ``rtc_launch.launches`` and by stage kind in
    ``rtc_launch.stage_launches`` (the layout-collapsed kernel of a simple
    program is a map stage). ``force_scalar`` takes the scalar kernel
    where the vector one would run, to time the two side by side."""
    device = inputs[0].device if inputs else torch.device(
        "cuda", torch.cuda.current_device())
    if device.type != "cuda" or any(t.device != device for t in inputs):
        raise MXNetError(f"Rtc kernel: inputs on {[str(t.device) for t in inputs]}"
                         "; the kernel takes tensors on one CUDA card")
    grid, block = check_launch_dims(grid_dims, block_dims)
    if not prog.simple:
        return _staged_launch(prog, list(inputs), device, grid, block)
    by_name = {n: t for (n, _, _), t in zip(prog.inputs, inputs)}
    reads = [by_name[n] for n in prog.reads]
    outputs = [torch.empty(s, dtype=torch_dtype(dt), device=device)
               for _, s, dt in prog.outputs]
    if math.prod(prog.shape) == 0:
        return outputs
    key = (device.index, grid, block,
           tuple((tuple(t.shape), t.stride()) for t in reads))
    plan = prog.plans.get(key)
    if plan is None:
        plan = prog.plans[key] = _plan(prog, reads, device, grid, block)
    else:
        STATS["cache_hits"] += 1
    pointers = [ctypes.c_void_p(t.data_ptr()) for t in list(inputs) + outputs]
    argv = (ctypes.c_void_p * (1 + len(pointers)))(
        ctypes.addressof(plan.params), *(ctypes.addressof(p) for p in pointers))
    vector = plan.vector != 0 and not force_scalar and vector_aligned(
        [reads[k].data_ptr() for k in plan.flat]
        + [t.data_ptr() for t in outputs], plan.access)
    function, grid = ((plan.vector, plan.vector_grid) if vector
                      else (plan.kernel.function, plan.grid))
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rtc_launch(function, *grid, *plan.block, stream, argv)
    if err != 0:
        raise MXNetError(f"Rtc kernel {plan.kernel.name}"
                         f"{' (vector)' if vector else ''} launch (grid "
                         f"{grid}, block {plan.block}) failed: "
                         f"{lib.rtc_error_string(err).decode()} ({err})")
    rtc_launch.launches += 1
    rtc_launch.stage_launches["map"] += 1
    rtc_launch.vector_launches += int(vector)
    return outputs


rtc_launch.launches = 0
rtc_launch.vector_launches = 0  # of those, the vector kernel's
# launches by stage kind; a split reduction's fold counts as a reduce
rtc_launch.stage_launches = {"map": 0, "reduce": 0, "product": 0}

