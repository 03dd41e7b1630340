"""The benchmark's plain reference of the stitch: plain PyTorch, no
hand-written kernel, no captured program, no tiling.

A frozen copy of the main path's semantics as the port defines them at
the benchmark's first version: the same operations in the same order,
so that on the same inputs it gives the port's bytes but where a kernel
rounds differently from its plain form.  Where the port launches a CUDA
kernel (levels of at least ``pallas_min_pixels``), this package runs the
plain form of that kernel's contract (edge-replicated windows), as the
port's own plain versions do on the CPU.

It imports nothing of the port, nothing of the JAX package and no JAX,
and takes nothing the port made: the benchmark hands it the same input
canvases it hands the port, and it works the crop windows out again.

``FlowParams.dtype`` is the solver's working type: float32 as the
configurations state it, bfloat16 for the control that the limits of
``portbench.compare`` are held against.
"""
