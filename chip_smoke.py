#!/usr/bin/env python3
"""Smoke test of lasso_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, builds the port's kernels from
``lasso_tpu_torch/csrc/`` and runs in phases; any failure exits non-zero
before the last line is printed.

0. The card's name and power limit, the build time of the kernels, and
   the HGMMA (warpgroup MMA) instructions in their SASS: in both K6a
   kernels, in all four K1/K2 kernels and in every instantiation of the
   four K9a/K9b kernels (``conv``), and in no other kernel of ``omp`` or
   ``fista``.
1. Each CUDA kernel against its plain PyTorch version on the card:
   ``fused_fista_step`` and ``fused_fista_multistep`` (S=4) in f32 and
   bf16, plain and with restart (multistep), a per-feature threshold row,
   nonneg and l2, at a ragged shape and at the headline shape, with the
   step 0.9 / L (L the Lipschitz constant of the shape's W); then K1
   and K2 alone at the headline shape, given the operands a call makes
   once (W's split, and r's split as K1 writes it, which must equal the
   split of K1's r), as a multistep call's sub-steps run them: K2 also
   writes the next momentum point's split, and K1 reads it (bit for bit
   the r of K1 forming y, whose time is printed beside), timed beside
   their plain versions and a PyTorch library yardstick, each kernel no
   slower than its yardstick. The bound counts the bytes each timed call
   reads and writes and, in 'f32', the three bf16 products of its split on
   the tensor cores. Tolerances: f32 z atol 1e-5 and delta rtol 1e-5; bf16
   z atol 5e-3 and delta rtol 5e-2 (delta is summed with atomics, in an
   order that changes from run to run); K1's residual (values of order 1,
   sums of K products) atol 1e-4.
2. The main path: the headline encode (N=16384, D=512 -> K=2048,
   alpha=0.1, lr=1/L, 200 iterations, tol=0, 'mixed' with a 37-iteration
   f32 tail) through ``sparse_encode``, with the launch counts read just
   before and after, its iterations/s, and gap_vs_f32_pct against an
   all-f32 solve of the same budget and an 8x-budget f32 anchor (f64
   objectives on the host).
3. The single-step path: 37 iterations in f32 (two blocks of 16 and five
   ``fused_fista_step`` calls); then ``fused_fista_step`` alone at the
   headline shape, held to its plain version and timed beside it and the
   library's products, its own row of the kernels line.
4. Serving through the CLI: ``python -m lasso_tpu_torch encode`` on 40000
   rows in chunks of 16384 (the last one ragged), checked row for row
   against direct ``sparse_encode`` calls.
5. The coordinate-descent kernels against their plain versions on the
   card, at 200x(256->384) and at 16384x(512->2048): ``fused_cd_steps``
   (8 steps) in f32 and bf16, plain and with a per-feature row, nonneg,
   l2 and rows inactive on entry (b and z atol 1e-6, the active mask
   equal); ``fused_cd_mod_sweep`` with converged rows and a zero atom (z
   and R atol 1e-4 after one sweep, zmax and dzmax rtol 1e-5) against its
   plain version at the kernel's 16-atom chunk. Then both alone at the
   headline shape, timed beside their plain versions, and K3 and K4 also
   at the training width (16384x(256->1024)), each width a row of its own
   (K4's with the bound of its FP32 FFMA route).
6. Training through the CLI at the training width (N=16384, D=256 ->
   K=1024, alpha=0.1; signals drawn from a sparse model over a random
   dictionary): ``python -m lasso_tpu_torch train --steps 3
   --solver-args '{"algorithm": "cd"}'``, 3 E-steps of 12 fused blocks of
   8 greedy steps (36 ``cd_steps`` launches unless every row of an E-step
   freezes first) and 4 unfused steps each, with the sequential M-step.
   Checks: losses non-increasing, unit atoms, finite codes; EM steps/s and
   the E-step and M-step times of one step; one EM step with
   ``use_pallas=False`` on the card (losses rtol 1e-4).
7. Cyclic CD: ``dict_learning(algorithm='cd-mod', max_iter=20, tol=1e-4,
   dict_update='block')`` for 2 steps at the training width (the EM
   step's time, K4's launches there and sweeps/s), then one
   ``coord_descent_mod`` at 16384x(512->2048) (sweep launches equal to
   ``n_iter``, finite gaps, sweeps/s; torch.profiler's split of a solve
   into K4, the gap check's kernels and the host), held against
   ``use_pallas=False`` at ``max_iter=5`` (z atol 1e-4, gap within 1e-4
   relative above 1). The K4 rows' launches are those of the solve at the
   headline and of the training at the training width.
8. The group-prox kernel (K5, ``csrc/group.cu``) against its plain version
   on the card, at 200x(128->256) and at 16384x(512->2048), in f32 and
   bf16: one 8-sub-step ``fused_group_fista_multistep`` (K1, K2 and K5 per
   sub-step) for contiguous blocks of 8, and for permuted ragged groups
   with Yuan-Lin weights, l1 and restart, held as
   tests/test_torch_fused_group.py holds the same call against JAX's
   kernel: f32 z atol 1e-4 (the bf16x3 split over 8 sub-steps,
   tests/test_group_lasso.py:282-286); bf16 the objective ``0.5 ||z W^T -
   x||^2 + sum_g thg_g ||z_g||`` rtol 1e-4, since the bf16 roundings of
   v^2 and of each group's scale part a solve from one that sums in
   another order by whole groups; delta rtol 1e-5 / 5e-2, the restart
   carry equal; then K5 alone at the headline shape, timed beside its
   plain version, with its bound.
9. The group-lasso slice at the width of ``benchmarks/group_bench.py``
   (N=16384, D=512 -> K=2048, groups of 8, alpha=0.1, lr=0.05, 200
   iterations, tol=0, unit atoms from ``default_rng(0)``):
   ``sparse_encode(algorithm='group-ista')`` in 'f32', 'mixed' and 'f32'
   with restart (iterations/s, launch counts, f64 objectives); the f32
   objective against the unfused path on the card (relative 1e-5); the
   mixed gap ``100 (f_mixed - f_f32) / (f_f32 - f_anchor)`` with an
   8x-budget f32 anchor, printed, and the objectives in the order f32 <=
   mixed <= bf16 (the 5% promise of 'mixed' does not hold for this
   problem, in the JAX package either); ``encode --algorithm group-ista``
   through the CLI on 40000 rows in chunks of 16384, against direct
   ``sparse_encode`` calls; ``lasso_path(mode='batched',
   algorithm='group-ista')`` over 4 alphas at N=4096; and
   ``chunked_encode(screen=True)`` at alpha=3.5, where screening shrinks
   K, against the unscreened encode (atol 1e-4).
10. The OMP kernels against their plain versions on the card: the fused
   solve (K6a ``omp_select`` on the tensor cores, K6b ``omp_orth``, which
   streams the live rows of Q through shared memory by bulk copies up to
   D = 1024, K6d ``omp_orth_cgs2`` with ``gs='cgs2'``, K6c ``omp_backsub``
   of ``csrc/omp.cu``) at 1000x(256->512), N not a multiple of the 128-row
   tile, with each Gram-Schmidt, with T=13 in f32 (K6a's bf16x3 split) and
   bf16, with a tol freeze mid-run (T=16), by
   the JAX tests' equivalence rule (codes atol 2e-4 where the supports
   agree, else the per-row rss rtol 1e-3) and validity equal; with
   duplicated atoms, finite codes and the per-row rss (rtol 1e-3) on every
   row, since the pivot floor leaves the split of weight across a
   dependent pair to rounding; K7 ``chol_append_solve`` of ``csrc/chol.cu``
   over T appends from the identity (T=16 and 64 on its panel kernel,
   T=72 on its sweep kernel, in place and into a new factor, every fifth
   system the identity) at rtol 2e-4 / atol 1e-5; K6c bit for bit its
   plain version on systems with frozen samples at T=64 with R one float
   off a 16-byte boundary (its staged kernel's 4-byte copies) and at
   T=136 (its warp kernel). Then each entry at the headline width (16384x512->2048, T=64,
   ``benchmarks/omp_fused_bench.py``'s problem): one solve in f32, one in
   bf16 and one in f32 with ``gs='cgs2'``, with CUDA events around every
   launch, each held to the plain solve of its precision and Gram-Schmidt
   by the headline rule below; K6a's step-0 partials (rtol 1e-5 / atol
   1e-6; bound: one bf16 product on the tensor cores, three in f32), K6b's
   and K6d's step 32 from one state (idx, valid and masks equal; r, q_k,
   R's column, d_k and r's bf16 split at rtol 2e-4 / atol 1e-5) and K6c on
   the f32 solve's state (bit for bit) against their plain versions, with
   the kernels' tiers named, K6b's and K6d's rows with their times at
   steps 0, 32 and 63
   beside the mean over the 64 steps; K7 over 64 appends against its plain
   version (rtol 2e-4 / atol 1e-5), and in place against a new factor at
   k=32. The plain versions are timed by CUDA-graph replays, which leave
   out the host's time to enqueue their many small ops; K6c's time is the
   mean of 20 launches on the f32 solve's state, its library time
   ``torch.linalg.solve_triangular`` on the same R and d.
11. The OMP slice at that width through ``sparse_encode(algorithm='omp',
   n_nonzero_coefs=64)``: 'auto' (must take the fused kernels: 64
   ``omp_select_f32`` and ``omp_orth`` launches and one ``omp_backsub``),
   'fused' in bf16, 'chol' (64 ``chol_append_solve`` launches) and 'auto'
   with a tol that about half the rows reach; solves/s and ms a step;
   at most 64 nonzeros a row and finite codes; 'fused' and 'chol' by the
   headline rule; the bf16 mean rss within 5e-2 of f32's;
   ``fused_omp_solve(gs='cgs2')`` in f32 (64 ``omp_orth_cgs2`` launches,
   no ``omp_orth``; solves/s), held to the 'mgs' solve by the headline
   rule; and
   ``encode --algorithm omp`` through the CLI on 40000 rows in chunks of
   16384, against direct ``sparse_encode`` calls (the equivalence rule).
   The headline rule for two fits of 16384 rows: codes atol 2e-4 on the
   rows whose supports agree, and at most 32 rows that part (three and a
   half times the most measured), each of them in both fits an OMP
   solution up to near-ties in float64 (an order of its support in which
   every atom scores within 1e-4 relative of the best, for a bf16 fit
   within 1e-3 with bf16-rounded operands, and codes within 2e-4 of the
   least-squares fit). The JAX tests'
   rss fallback is printed but not held there: at T=64 two greedy paths
   that part at a near-tie go on apart, and their rss differ by more than
   1e-3 (PERF.md).
12. The Cholesky solve kernel (K8 ``chol_solve`` of ``csrc/chol.cu``: a
   warp kernel with the factor in registers up to D = 64, at D rounded up
   to 16, 32 or 64, and a block a sample over 32 x 32 tiles above) against
   its plain version on the card, on A = Q Q^T + 2 I with Q standard normal
   (tests/test_linalg.py:140-159), at B=16384 and D=64 (the 'chol-full'
   solve's shape), B=1024 and D=256 (the gate's limit), D=12, 16, 33, 65
   and 100 at B=130, and B=1 at D=64 and 256: x at rtol 1e-4 / atol
   1e-5. One sample that is not PD gives a non-finite x from the
   kernel and finite ones elsewhere, and ``batch_cholesky_solve`` then
   takes the LU solve once for the whole batch (atol 1e-4 against a
   float64 solve). Then K8 alone at B=16384, D=64, timed beside its plain
   version (CUDA-graph replays) and ``torch.linalg.cholesky_ex`` +
   ``torch.cholesky_solve`` as the library yardstick (its card time by
   torch.profiler: MAGMA's batched solve cannot be captured in a graph),
   with its bound (one triangle of the symmetric A, b and x); and its time
   at B=1024, D=256.
13. OMP 'chol-full' at the width of phase 11 through
   ``sparse_encode(algorithm='omp', n_nonzero_coefs=64,
   solver='chol-full')``, the main run of this slice: 64 ``chol_solve``
   launches and no LU fallback, solves/s and ms a step, codes finite with
   at most 64 nonzeros a row, held to the fused solve by the headline rule
   of phase 11; K8's share of the kernel time of a solve (torch.profiler);
   'chol-full' with a tol that about half the rows reach (frozen rows'
   rss at most tol, one K8 launch a step); an explicit 'chol' with
   ``use_pallas=False`` at 1000x(256->512), T=13, which must warn and give
   the codes of 'chol-full' on the library's factorization; and OMP
   dictionary learning at the training width (T=16, 3 EM steps, the
   sequential M-step), whose losses must not rise.
14. The conv-FISTA kernels (K9a ``conv_decode_resid`` and K9b
   ``conv_adjoint_prox`` of ``csrc/conv.cu``) against their plain versions
   on the card: three sub-steps of ``fused_conv_fista_multistep`` in f32
   and bf16 at a ragged shape (Cx=2, 4x2 atoms, pad 1, nonneg), kw=9 and
   kw=11, a per-channel threshold, restart, and the headline (256 images
   1x32x32, 64 atoms 7x7) and rich (64 images 16x32x32, 256 atoms 5x5)
   shapes. Tolerances: f32 codes atol 3e-5 * max(1, |z|max) (JAX's),
   delta 1e-5 relative; bf16 codes 1e-3 * scale, delta 1e-4; the restart
   t equal. Then each kernel alone at the headline and rich shapes, given
   W's parts made once (``conv_operands``, as a call's sub-steps run
   them), timed behind ``hold_the_card``'s queued work, beside its bound
   (in 'f32' three bf16 products on the tensor cores), its plain version
   and cuDNN (``conv_transpose2d`` for K9a, ``conv2d`` for K9b, TF32 off;
   in bf16 on bf16 tensors), both as CUDA-graph replays; the rich rows are
   printed beside the headline rows.
15. Conv sparse coding through ``ista_conv2d`` at
   ``benchmarks/conv_fused_bench.py``'s widths (alpha 0.1, lr = 1 / the
   Araujo bound, 200 iterations, tol 0): the headline in 'f32', 'bf16',
   'mixed' and f32 with restart (the main run of this slice, counts read
   around it: 200 K9a and 200 K9b launches a solve), iterations/s as the
   minimum over three inputs; the kernel / host split of an f32 and a
   bf16 solve (torch.profiler's kernel time against the wall time); the
   fused f32 f64 objective within 1e-5 relative of the unfused route
   (cuDNN, TF32 off); gap_vs_f32_pct of
   'mixed' and 'bf16' against a 1600-iteration f32 anchor; tol runs
   (1e-5, and 1e-4 where both routes stop early) whose fused n_iter lies
   on a block boundary at or above the unfused one; the rich width in f32
   and 'mixed' with the same parity check; and
   ``chunked_encode(algorithm='ista_conv2d')`` on 600 images in chunks of
   256 against direct calls, row for row.

16. The rest of ``sparse_encode`` at the headline width (16384x512->2048,
   alpha 0.1) through its entry: 'gpsr' (500 iterations), 'iter-ridge'
   (Woodbury CG), 'interior-point' ('auto' = 'cg' here, 20 Newton
   iterations of at most 128 CG iterations), 'split-bregman' in 'f32'
   (100 outer iterations) and 'mixed' (200), 'own', ``constrained_inference``
   in its penalized and (a cut bisection) constrained forms, and OMP
   ``solver='cg'`` at T=64, held to 'chol-full' by phases 10-11's rule;
   then at the training width (16384x256->1024) 'iter-ridge' with
   ``woodbury_solver='cholesky'`` and 'interior-point' with
   ``kkt_solver='cholesky'``, the main run of this slice: each ridge or
   Newton step launches K8 once (counts set to 0 just before these two
   solves and read after; no LU fallback), and K8 alone at that shape
   (B=16384, D=256) held to its plain version by phase 12's rule and timed
   beside it, the library and its bound: its own row of the kernels line.
   Each solve runs twice: first under CUDA's sync debug mode (its
   synchronizing CUDA calls; interior-point 'cg' (tracing the card only)
   and the Cholesky routes (the host's operations too) also inside
   torch.profiler, for their kernel time by name), then timed
   between two synchronizes, with the launch counts and the inner loops'
   iterations (conjugate gradients, backtracking searches, counted as they
   run) read around it. For each solve: wall time, n_iter, inner
   iterations, synchronizing calls, the kernel split against the wall
   time where profiled (for interior-point 'cg' its ms a CG iteration and
   the CG products' rate), the f64 objective's gap to a deep f32 FISTA solve of
   the port (3200 iterations; 1600 within 1e-5 of it), which must stay
   under the bound of the solver's JAX test, an objective at most its
   z0's, finite codes, and the KKT violation.

17. Conv dictionary learning and implicit differentiation, the main run
   of this slice: ``conv_dict_learning`` at ``benchmarks/conv_dl_bench.py``'s
   widths (the rich 64x16x32x32 images with 256 filters 5x5 and the
   headline 256x1x32x32 with 64 filters 7x7; alpha 0.1, constrained, 5 EM
   steps, E-steps of 30 iterations at tol 0) in 'f32' and 'mixed', each on
   its own input after a warm-up run under CUDA's sync debug mode: EM
   steps/s, one step's E-step and M-step time, CG iterations an M-step,
   host syncs an EM step, and K9a/K9b launches (counts set to 0 just
   before the run, 150 each), losses finite and non-increasing, unit
   filters within 1e-4, and an unfused 'f32' run whose losses agree at
   rtol 1e-4. Then the gradient of sum(z^2) in x and W through
   ``make_implicit_encoder`` (K1 + K2) and ``make_implicit_group_encoder``
   (groups of 8, lr 0.05; K1 + K2 + K5) at 16384x512->2048 and through
   ``make_implicit_conv_encoder`` (K9a + K9b) at the conv headline, 200
   iterations at tol 0, 64 CG iterations: forward and backward seconds,
   the backward's CG iterations and syncs, the forward's launches, the
   support; each held to the same gradient with ``use_pallas=False``
   under the bounds of ``IMPLICIT_BOUND`` (near-singular supports make
   the ridge-free gradient sensitive), and the linear and group ones
   again with ridge 1.0, their agreeing samples within 1e-3. Phase 17's
   launches are added to the rows of the same kernel at the same shape;
   K9a/K9b at the rich width get rows of their own (phase 14's timings).

18. The nonlinear solvers at BASELINE.md row 5's width (a tanh-MLP decoder
   2048x(128->512), hidden width 512), f32 with TF32 off: on a linear
   decoder (unit atoms, alpha 0.1) ``ista_nl`` at lr 1/L and 'auto',
   ``owlqn`` batch and per-sample and ``split_bregman_nl('cg')`` on the
   flattened batch ('exact' on one sample), and ``iterative_ridge_bfgs``
   at K=256 in both modes from the ridge start, each held to a 3200-
   iteration FISTA anchor by its JAX test's bound, and ``ista_nl`` held to
   the linear ista code by code; on the MLP (alpha 0.05) ``ista_nl``
   (fixed lr, 'auto', lr_refresh 4, restart; 200 iterations at tol 0),
   ``owlqn`` (brent; per-sample backtracking), ``split_bregman_nl`` and
   ``iterative_ridge_bfgs`` at K=256 in both modes (the main run of this
   slice: K8 ``chol_solve`` launches equal to the iterations run, no LU
   fallback), each run once under CUDA's sync debug mode (its
   synchronizing calls an iteration) and timed in that run, ``ista_nl`` at
   a fixed lr and restarted timed three times more, its f64 objective
   finite and below
   the start's, lr_refresh 4 within 1e-3 of 1; K8 alone at B=2048, D=256
   held to its plain version and timed beside it, the library and its
   bound (its own row of the kernels line); ``make_implicit_nl_encoder``
   with the linear decoder against ``make_implicit_encoder`` (ridge 1.0),
   with the MLP in float64 on 64 rows against central differences, and
   with the MLP in f32 at full width, timed.
19. The parallel layer (``lasso_tpu_torch.parallel``) on
   ``torch.distributed``. One NCCL rank on an in-memory store:
   ``data_parallel_encode`` at the headline ('mixed', 200 iterations, tol
   1e-5, so that the all-reduced stop runs) bit for bit with
   ``sparse_encode``, with the same count and K1/K2 launches;
   ``make_train_step``, 5 EM steps at the training width, and
   ``data_parallel_encode_conv2d`` and ``make_conv_train_step``, 5 EM
   steps, at the conv headline, each held bit for bit to its
   single-process counterpart (the conv steps with cuDNN's deterministic
   algorithms on both sides: its default weight gradient does not repeat
   its last bits). One conv EM step of each side under torch.profiler:
   its kernel time by name and its host's costliest operations. Then two
   processes sharing the card over gloo (``chip_smoke.py
   --parallel-rank``), 8192 rows each: the codes within 1e-5 of the
   single process and the same count, at 16384 and at 16383 rows. Each
   call's seconds (the median of 5 calls, or of the 5 EM steps; the
   gloo ranks' of 3) beside the single process's.
20. The last modules. (a) The native C++ host pipeline
   (``lasso_tpu_torch.native``, built by g++ from the checkout) at
   BASELINE.md row 4: 400 stroke images 28x28, dense 8x8 patches and
   their centring equal to the numpy versions (centring within 1e-6),
   41 random patches an image (seed 0) repeatable and equal at one
   thread, each a window of its image, the first 16384 centred as the
   training data; the seconds of each step. (b) CSR serving at phase 4's
   width: ``chunked_encode`` dense and with ``output='csr'`` (unpacked bit
   for bit the dense codes, ``row_ptr[-1]`` their nonzero count, the same
   K1/K2 launches) and ``encode --csr`` through the CLI (its three files
   unpack to the same codes); the seconds of each, of the packing, and
   the dense against the CSR bytes. (c) ``export_encoder`` at the
   headline ('mixed', 200 iterations, tol 1e-5, lr 'auto', a symbolic
   batch), loaded and called at 16384 and 4096 rows: bit for bit
   ``sparse_encode`` with the same K1/K2 launches; an export at tol 1e-2
   stops early with ``sparse_encode``'s codes, iterations and launches;
   the blob's
   bytes, export, load and call seconds beside ``sparse_encode``'s.
   (d) ``dict_learning_resumable`` on (a)'s patches (16384x64 -> 256,
   alpha 0.1, sequential M-step, 10 EM steps of 50 iterations, a
   checkpoint every 3 steps): bit for bit ``dict_learning``, and after the
   checkpoints past step 6 are deleted the resumed run (4 steps of K1/K2
   launches) bit for bit the uninterrupted one; seconds per step and per
   save, and a checkpoint's bytes. (e) ``config_for('ista', ...)``
   against ``sparse_encode`` bit for bit with equal launches;
   ``capture_trace`` of a ``trace('encode')`` region holding the region
   and the K1/K2 kernel names; ``time_solver`` of phase 2's encode beside
   phase 2's seconds; ``debug_nans`` raising on ``log(-1)`` on the card and
   not in a headline encode. Phase 20's K1/K2 launches are added to the
   headline rows of the kernels line.

Before the last line it prints the kernels' JSON line and the card's
name and power limit as nvidia-smi gives them; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import itertools
import json
import os
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from lasso_tpu_torch import headline_bench  # noqa: E402
from lasso_tpu_torch.linalg import basic, lipschitz_constant  # noqa: E402
from lasso_tpu_torch import linear  # noqa: E402
from lasso_tpu_torch.linear import lasso_path, sparse_encode  # noqa: E402
from lasso_tpu_torch.linear.solvers import coord_descent_mod  # noqa: E402
from lasso_tpu_torch.conv2d import (  # noqa: E402
    conv_dict_learning, ista_conv2d, lip_bound_conv2d, lip_constant,
    make_implicit_conv_encoder, update_kernel_constrained)
from lasso_tpu_torch.linear import (  # noqa: E402
    make_implicit_encoder, make_implicit_group_encoder)
from lasso_tpu_torch.ops import _cuda  # noqa: E402
from lasso_tpu_torch.ops import batched_cholesky as B  # noqa: E402
from lasso_tpu_torch.ops import fused_cd as C  # noqa: E402
from lasso_tpu_torch.ops import fused_conv as FC  # noqa: E402
from lasso_tpu_torch.ops import fused_group as G  # noqa: E402
from lasso_tpu_torch.ops import fused_ista as F  # noqa: E402
from lasso_tpu_torch.ops import fused_omp as O  # noqa: E402
from lasso_tpu_torch.ops.common import INNER_ITERATIONS  # noqa: E402
from lasso_tpu_torch.nonlinear import (  # noqa: E402
    hessian_2norm, ista_nl, iterative_ridge_bfgs, make_implicit_nl_encoder,
    owlqn, split_bregman_nl)
from lasso_tpu_torch import native  # noqa: E402
from lasso_tpu_torch.utils import (  # noqa: E402
    capture_trace, chunked_encode, config_for, debug_nans,
    dict_learning_resumable, export_encoder, from_numpy_tree, latest_step,
    load_encoder, time_solver, trace)

N, D, K = headline_bench.N, headline_bench.D, headline_bench.K
ALPHA = headline_bench.ALPHA
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"f32": 67e12,        # FP32 outside the tensor cores
              "bf16": 989e12}      # dense bf16 on the tensor cores
TOL = {"f32": (1e-5, 1e-5), "bf16": (5e-3, 5e-2)}   # z atol, delta rtol
SOURCE = "lasso_tpu_torch/csrc/fista.cu"
REPLACES = "lasso_tpu/ops/fused_ista.py:447"
CD_SOURCE = "lasso_tpu_torch/csrc/cd.cu"
CD_REPLACES = {"cd_steps": "lasso_tpu/ops/fused_cd.py:157",
               "cd_mod_sweep": "lasso_tpu/ops/fused_cd.py:317"}
TRAIN_N, TRAIN_D, TRAIN_K = 16384, 256, 1024   # the training width
GROUP_SOURCE = "lasso_tpu_torch/csrc/group.cu"
GROUP_REPLACES = "lasso_tpu/ops/fused_group.py:283"
GS, GROUP_ALPHA, GROUP_LR = 8, 0.1, 0.05       # benchmarks/group_bench.py
CLI_ROWS, CLI_CHUNK = 40000, 16384              # phases 4, 9 and 11
OMP_SOURCE = "lasso_tpu_torch/csrc/omp.cu"
OMP_REPLACES = "lasso_tpu/ops/fused_omp.py:308"
CHOL_SOURCE = "lasso_tpu_torch/csrc/chol.cu"
CHOL_REPLACES = "lasso_tpu/ops/batched_cholesky.py:290"
CHOL_SOLVE_REPLACES = "lasso_tpu/ops/batched_cholesky.py:366"
OMP_T = 64                                      # benchmarks/omp_fused_bench.py
# rows of 16384 that two OMP fits at the headline may part on: the most
# measured is 9 (the bf16 kernels against their plain version), and the
# cap three and a half times that (PERF.md, PR 5)
OMP_PARTING = 32
# the near-tie certificate's relative gap for each selection precision:
# f32 paths part at gaps near 1e-6; in bf16 the kernel's and the float64
# residual round to bf16 differently in a few elements, which moved a
# score by up to 2.0e-4 (PERF.md, PR 5), here with five times that
CERT_EPS = {"f32": 1e-4, "bf16": 1e-3}
PATH_N, SCREEN_ROWS, SCREEN_CHUNK = 4096, 8192, 2048
CONV_SOURCE = "lasso_tpu_torch/csrc/conv.cu"
CONV_REPLACES = "lasso_tpu/ops/fused_conv.py:531"
# benchmarks/conv_fused_bench.py's configurations (N, Cz, Cx, k) over 32x32
# images, k x k atoms, stride 1, padding 0, alpha 0.1
CONV_CONFIGS = {"headline": (256, 64, 1, 7), "rich": (64, 256, 16, 5)}
CONV_ALPHA, CONV_ITERS, CONV_SERVE, CONV_CHUNK = 0.1, 200, 600, 256
# K9a/K9b against their plain versions: f32 codes at JAX's 3e-5 * max(1,
# |z|max) and delta at 1e-5 relative; bf16 codes at 1e-3 * scale and delta
# at 1e-4 (a residual element that rounds to the other bf16 neighbour in
# the kernel than in cuDNN's sum moves the codes by lr |W| 2^-8 |r|: up to
# 4.2e-4 measured)
CONV_TOL = {"f32": (3e-5, 1e-5), "bf16": (1e-3, 1e-4)}
DEV = torch.device("cuda")
DL = importlib.import_module("lasso_tpu_torch.linear.dict_learning")
CKPT = importlib.import_module("lasso_tpu_torch.utils.checkpoint")
SCR = importlib.import_module("lasso_tpu_torch.linear.screening")
SE = importlib.import_module("lasso_tpu_torch.linear.sparse_encode")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def hold_the_card():
    """Enqueue about 20 ms of work on the card (an 8192^3 f32 product), so
    that the launches enqueued after it wait for the card and not for the
    host: the events between them then time the card alone, also for a
    kernel shorter than its Python wrapper."""
    a = torch.full((8192, 8192), 1e-3, device=DEV)
    torch.matmul(a, a)


def cuda_ms(fn, reps=20, warm=3):
    """Mean time of ``fn`` on the card from CUDA events over ``reps``
    calls, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    hold_the_card()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_seconds(fn):
    """Seconds of CUDA kernel time of one call of ``fn``, from
    torch.profiler (0.0 when the profiler records no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def profiled(fn, host_ops=True):
    """One call of ``fn`` under torch.profiler: its result and the
    milliseconds of CUDA kernel time of the call by kernel name. Names are
    cut to 40 characters, and the kernels whose names share those 40 are
    added up under them. Without ``host_ops`` only the card's activity is
    traced, which slows a call of many small operations far less."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        out = fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms[e.key[:40]] += e.self_device_time_total / 1e3
    return out, {k: round(v, 4) for k, v in ms.items()}


def kernel_ms_by_name(fn):
    """Milliseconds of CUDA kernel time of one call of ``fn`` by kernel
    name (see :func:`profiled`)."""
    return profiled(fn)[1]


def sass_mma_counts(library):
    """{mangled kernel name: HGMMA instructions} in the SASS of a built
    library, read with the cuobjdump beside nvcc."""
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           str(_cuda.library_path(library))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            counts[kernel] = 0
        elif kernel is not None and "HGMMA" in line:
            counts[kernel] += 1
    return counts


def operands(n, d, k, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=DEV)
    W = torch.randn(d, k, generator=g, device=DEV) / d ** 0.5
    z = torch.randn(n, k, generator=g, device=DEV) * 0.1
    zp = torch.randn(n, k, generator=g, device=DEV) * 0.1
    arow = 0.02 + 0.05 * torch.rand(1, k, generator=g, device=DEV)
    t = torch.where(torch.rand(n, 1, generator=g, device=DEV) < 0.5, 0.0,
                    1.0 + 3.0 * torch.rand(n, 1, generator=g, device=DEV))
    return x, W, z, zp, arow, t


def phase_kernel_cases():
    """Both wrappers against their plain versions on the same inputs on
    the card: plain, and with a per-feature row, nonneg and l2 (and
    restart, for the multistep), at a ragged and at the headline shape.
    The step is 0.9 / L: above 1/L the iterates grow from step to step
    (with lr = 0.2 at the headline, where L is about 9, by about 1.6x a
    step), and with them the differences that the bf16x3 split of 'f32'
    leaves between two orders of summation (PERF.md, section 6)."""
    moms = torch.linspace(0, 0.6, 4)
    for n, d, k in ((200, 300, 500), (N, D, K)):
        x, W, z, zp, arow, tv = operands(n, d, k, seed=n)
        lr = 0.9 / float(lipschitz_constant(W))
        for kp in ("f32", "bf16"):
            atol, rtol = TOL[kp]
            for variant in ("plain", "restart_row_nonneg_l2"):
                if variant == "plain":
                    step_kw = dict(alpha=0.05)
                    multi_kw = dict(threshs=0.05 * lr, t_vec=None)
                else:
                    opts = dict(nonneg=True, l2=0.3)
                    step_kw = dict(alpha=arow, **opts)
                    multi_kw = dict(threshs=arow * lr, t_vec=tv, **opts)
                pairs = (
                    ("fused_fista_step",
                     lambda f: f(x, z, zp, W, lr, mom=0.5,
                                 kernel_precision=kp, **step_kw),
                     F.fused_fista_step, F.fused_fista_step_plain),
                    ("fused_fista_multistep",
                     lambda f: f(x, z, zp, W, lr, moms=moms, steps=4,
                                 kernel_precision=kp, **multi_kw),
                     F.fused_fista_multistep, F.fused_fista_multistep_plain))
                for name, call, kernel, plain in pairs:
                    got = call(kernel)
                    torch.cuda.synchronize()
                    want = call(plain)
                    err = max(float((a - b).abs().max())
                              for a, b in zip(got[:-1], want[:-1]))
                    dg, dw = float(got[-1]), float(want[-1])
                    print(f"[1] {name} {kp} {variant} {n}x{d}->{k}, lr "
                          f"{lr:.4f}: "
                          f"max|err| {err:.3e} (atol {atol:g}), delta "
                          f"{dg:.8g} vs {dw:.8g} (rtol {rtol:g})")
                    check(err <= atol and abs(dg - dw) <= rtol * abs(dw),
                          f"{name} {kp} {variant} at {n}x{d}->{k}")
    print("[1] launch counts:", json.dumps(_cuda.launch_counts()))


def phase_kernel_timing():
    """K1 and K2 alone at the headline shapes: error against the plain
    version, time, the plain version's time, a library yardstick, and the
    bound from shapes."""
    x, W, z, zp, _, _ = operands(N, D, K, seed=1)
    scal = torch.tensor([0.2, 0.002, 0.5, 1.0], device=DEV)
    r_out = torch.empty(N, D, device=DEV)
    rows = []
    for kp in ("bf16", "f32"):
        lib = torch.bfloat16 if kp == "bf16" else torch.float32

        def lib_resid():
            y = z + 0.5 * (z - zp)
            return torch.matmul(y.to(lib), W.to(lib).T).float() - x

        ops = F.fista_operands(W, N, kp, with_y=True)
        r = F.fista_resid(x, z, zp, W, scal, kernel_precision=kp,
                          operands=ops)
        torch.cuda.synchronize()
        err1 = float((r - F.fista_resid_plain(x, z, zp, W, scal,
                                              kernel_precision=kp)
                      ).abs().max())
        check(torch.equal(ops.rb, F._bf16_parts(r, kp)),
              f"K1 {kp}: r's split as K1 writes it is the split of its r")
        # K2 as a multistep call's sub-steps run it: it also writes the
        # next momentum point's split, y = z1 + 0.5 (z1 - z), which K1
        # then reads in place of forming it from z1 and z
        z1, _ = F.fista_grad_prox(r, z, zp, W, scal, kernel_precision=kp,
                                  operands=ops, next_scal=scal)
        torch.cuda.synchronize()
        z1p, _, _ = F.fista_grad_prox_plain(r, z, zp, W, scal,
                                            kernel_precision=kp)
        err2 = float((z1 - z1p).abs().max())
        r1 = F.fista_resid(x, z1, z, W, scal, kernel_precision=kp,
                           operands=ops, y_split=True).clone()
        err1 = max(err1, float((r1 - F.fista_resid_plain(
            x, z1, z, W, scal, kernel_precision=kp)).abs().max()))
        check(torch.equal(r1, F.fista_resid(x, z1, z, W, scal,
                                            kernel_precision=kp,
                                            operands=ops)),
              f"K1 {kp} reading y's split as K2 wrote it, against forming y")
        check(err1 <= 1e-4 and err2 <= TOL[kp][0],
              f"K1/K2 {kp} against plain at the headline shape")
        form_ms = cuda_ms(lambda: F.fista_resid(
            x, z, zp, W, scal, kernel_precision=kp, out=r_out, operands=ops))
        print(f"[1] fista_resid_{kp} forming y from z and z_prev (a call's "
              f"first sub-step, restart, the group path): {form_ms:.4f} ms")

        def lib_grad_prox():
            y = z + 0.5 * (z - zp)
            g = torch.matmul(r.to(lib), W.to(lib)).float()
            return torch.nn.functional.softshrink(y - 0.2 * g, 0.002)

        # the bytes of the calls as timed, each input read once and each
        # output written once: K1 reads y's split (P bf16 planes), x and
        # W's split and writes r and r's split; K2 reads r's split, W^T's,
        # z and z_prev and writes z+, the next y's split and delta
        P = 2 if kp == "f32" else 1
        nbytes1 = 2 * P * (N * K + D * K + N * D) + 4 * 2 * N * D
        nbytes2 = 2 * P * (N * D + D * K + N * K) + 4 * (3 * N * K + 1)
        flops = 2 * N * K * D
        for name, err, nbytes, kern, plain, librar in (
                (f"fista_resid_{kp}", err1, nbytes1,
                 lambda: F.fista_resid(x, z1, z, W, scal,
                                       kernel_precision=kp, out=r_out,
                                       operands=ops, y_split=True),
                 lambda: F.fista_resid_plain(x, z, zp, W, scal,
                                             kernel_precision=kp),
                 lib_resid),
                (f"fista_grad_prox_{kp}", err2, nbytes2,
                 lambda: F.fista_grad_prox(r, z, zp, W, scal,
                                           kernel_precision=kp,
                                           operands=ops, next_scal=scal),
                 lambda: F.fista_grad_prox_plain(r, z, zp, W, scal,
                                                 kernel_precision=kp),
                 lib_grad_prox)):
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            # bf16 products on the tensor cores: one, or the three of the
            # bf16x3 split in 'f32'
            t_ops = ((3 if kp == "f32" else 1) * flops
                     / PEAK_FLOPS["bf16"] * 1e3)
            rows.append({
                "name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES, "launches": None,
                "max_abs_err": err, "ms": cuda_ms(kern),
                "plain_ms": cuda_ms(plain),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": cuda_ms(librar)})
            print(f"[1] {name}: {json.dumps(rows[-1])}")
            check(rows[-1]["ms"] <= rows[-1]["library_ms"],
                  f"{name} no slower than its library yardstick")
    return rows


def headline_problem():
    xs, W = headline_bench.make_problem()
    return xs[1], W


def phase_headline(x_np, W_np):
    """The main path, once, with the counts read around it."""
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    lr = float(1.0 / lipschitz_constant(W))
    kw = dict(algorithm="ista", lr=lr, maxiter=200, tol=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    z, n_iter = sparse_encode(x, W, ALPHA, kernel_precision="mixed",
                              mixed_tail_iters=37, return_iters=True, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    RESULTS["headline_s"] = seconds
    counts = _cuda.launch_counts()
    print("[2] headline launch counts:", json.dumps(counts))
    print(f"[2] peak device memory of the solve above its inputs: "
          f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")
    check(n_iter == 200, f"n_iter {n_iter} != 200")
    want = {"fused_fista_multistep": 9, "fused_fista_step": 0,
            "fista_resid_bf16": 163, "fista_grad_prox_bf16": 163,
            "fista_resid_f32": 37, "fista_grad_prox_f32": 37}
    for key, v in want.items():
        check(counts.get(key, 0) == v, f"{key}: {counts.get(key, 0)} != {v}")
    check(tuple(z.shape) == (N, K) and bool(torch.isfinite(z).all()),
          "headline codes finite and [N, K]")

    f_m = headline_bench.objective64(x_np, W_np, z)
    z_f = sparse_encode(x, W, ALPHA, kernel_precision="f32", **kw)
    f_f = headline_bench.objective64(x_np, W_np, z_f)
    z_a = sparse_encode(x, W, ALPHA, kernel_precision="f32",
                        **{**kw, "maxiter": 1600})
    f_a = headline_bench.objective64(x_np, W_np, z_a)
    gap = 100.0 * (f_m - f_f) / max(f_f - f_a, 1e-30)
    print(f"[2] headline: {200 / seconds:.2f} iterations/s "
          f"({seconds:.4f} s for 200), objective f64 mixed {f_m:.10g}, "
          f"all-f32 {f_f:.10g}, 1600-iteration f32 anchor {f_a:.10g}, "
          f"gap_vs_f32_pct {gap:.4f}, sparsity "
          f"{float((z == 0).float().mean()):.4f}")
    check(f_a <= f_f and gap < 10.0,
          "the mixed solve's gap-to-optimum within 10% of the f32 solve's")
    return counts


def phase_single_step(x_np, W_np):
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    z, n_iter = sparse_encode(x, W, ALPHA, lr=0.1, maxiter=37, tol=0.0,
                              kernel_precision="f32", return_iters=True)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    print("[3] single-step launch counts:", json.dumps(counts))
    check(n_iter == 37, f"n_iter {n_iter} != 37")
    for key, v in {"fused_fista_multistep": 2, "fused_fista_step": 5,
                   "fista_resid_f32": 37, "fista_grad_prox_f32": 37}.items():
        check(counts.get(key, 0) == v, f"{key}: {counts.get(key, 0)} != {v}")
    check(bool(torch.isfinite(z).all()), "single-step codes finite")

    # row 1 of PERF.md: fused_fista_step alone at the headline shape in
    # 'f32', as the five calls above run it (W split once a call, K1 then
    # K2), held to its plain version (TOL) and timed beside it and the
    # library's products. The bound: x, z, z_prev and W read once, z_next
    # written; the two products of the bf16x3 split, three bf16 products
    # each, on the tensor cores
    z_prev = torch.zeros_like(z)
    lr, mom = 0.1, 0.5

    def step():
        return F.fused_fista_step(x, z, z_prev, W, lr, ALPHA, mom,
                                  kernel_precision="f32")

    def plain():
        return F.fused_fista_step_plain(x, z, z_prev, W, lr, ALPHA, mom,
                                        kernel_precision="f32")

    def library():
        y = z + mom * (z - z_prev)
        g = torch.matmul(torch.matmul(y, W.T) - x, W)
        z_next = torch.nn.functional.softshrink(y - lr * g, ALPHA * lr)
        return z_next, torch.sum(torch.abs(z_next - z))

    (zk, dk), (zp, dp) = step(), plain()
    torch.cuda.synchronize()
    err = float((zk - zp).abs().max())
    check(err <= TOL["f32"][0] and abs(float(dk) - float(dp))
          <= TOL["f32"][1] * abs(float(dp)),
          "fused_fista_step against its plain version at the headline")
    t_bytes = 4 * (N * D + 3 * N * K + D * K + 1) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * 2 * (2 * N * K * D) / PEAK_FLOPS["bf16"] * 1e3
    row = {"name": "fused_fista_step", "route": "cuda", "source": SOURCE,
           "replaces": "lasso_tpu/ops/fused_ista.py:233",
           "launches": counts.get("fused_fista_step", 0),
           "max_abs_err": err, "ms": cuda_ms(step),
           "plain_ms": cuda_ms(plain), "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": cuda_ms(library)}
    print(f"[3] {json.dumps(row)} (a call: K1 + K2 and W's split; ms, "
          f"plain_ms and library_ms the mean of 20 calls after 3)")
    return row


def phase_cli():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40000, D)).astype(np.float32)
    W = (rng.standard_normal((D, K)) / np.sqrt(D)).astype(np.float32)
    solver = {"maxiter": 100, "tol": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("X.npy", "W.npy", "Z.npy")]
        np.save(paths[0], x)
        np.save(paths[1], W)
        argv = sys.argv
        sys.argv = ["lasso_tpu_torch", "encode", paths[0], paths[1], "-o",
                    paths[2], "--alpha", str(ALPHA), "--chunk-size", "16384",
                    "--solver-args", json.dumps(solver)]
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        runpy.run_module("lasso_tpu_torch", run_name="__main__",
                         alter_sys=True)
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        sys.argv = argv
        z = np.load(paths[2])
    print("[4] CLI launch counts:", json.dumps(counts))
    # 3 chunks x 100 iterations (S=25): 4 blocks of 25 f32 steps each
    for key, v in {"fused_fista_multistep": 12, "fista_resid_f32": 300,
                   "fista_grad_prox_f32": 300}.items():
        check(counts.get(key, 0) == v, f"{key}: {counts.get(key, 0)} != {v}")
    Wd = torch.from_numpy(W).to(DEV)
    for lo, hi in ((0, 16384), (32768, 40000)):
        direct = sparse_encode(torch.from_numpy(x[lo:hi]).to(DEV), Wd,
                               ALPHA, **solver).cpu().numpy()
        err = float(np.abs(z[lo:hi] - direct).max())
        print(f"[4] rows {lo}:{hi} against a direct sparse_encode: "
              f"max|err| {err:.3e}")
        check(err <= 1e-5, f"CLI rows {lo}:{hi} match a direct encode")
    check(z.shape == (40000, K) and np.isfinite(z).all(), "CLI codes")


def cd_operands(n, d, k, seed):
    """Unit atoms with one zero atom, S, b = x W, zero codes, an active
    mask with every 7th row inactive, a per-feature row, and for the sweep
    sparse warm codes, their residual and every 5th row converged."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=DEV)
    W = torch.randn(d, k, generator=g, device=DEV)
    W = W / W.norm(dim=0)
    W[:, 5] = 0.0
    S = torch.eye(k, device=DEV) - W.T @ W
    act = torch.ones(n, 1, device=DEV)
    act[::7] = 0.0
    arow = 0.05 + 0.1 * torch.rand(1, k, generator=g, device=DEV)
    z0 = torch.randn(n, k, generator=g, device=DEV) * (
        torch.rand(n, k, generator=g, device=DEV) < 0.05)
    conv = torch.zeros(n, dtype=torch.bool, device=DEV)
    conv[::5] = True
    return dict(x=x, W=W, S=S, b=x @ W, z=torch.zeros(n, k, device=DEV),
                act=act, arow=arow, z0=z0, R=x - z0 @ W.T, conv=conv,
                nrm=(W * W).sum(0))


def phase_cd_kernels():
    """Both CD wrappers against their plain versions on the same inputs,
    then each alone at the headline shape: time, plain time, bound."""
    rows = {}
    for n, d, k in ((200, 256, 384), (N, D, K)):
        o = cd_operands(n, d, k, seed=n)
        for kp in ("f32", "bf16"):
            for variant, kw in (("plain", dict(alpha=0.2)),
                                ("row_nonneg_l2_inactive",
                                 dict(alpha=o["arow"], nonneg=True, l2=0.3))):
                act = o["act"] if variant != "plain" else torch.ones_like(
                    o["act"])
                args = (o["b"], o["z"], act, o["S"])
                got = C.fused_cd_steps(*args, tol_k=0.05, steps=8,
                                       kernel_precision=kp, **kw)
                torch.cuda.synchronize()
                want = C.fused_cd_steps_plain(*args, tol_k=0.05, steps=8,
                                              kernel_precision=kp, **kw)
                err = max(float((a - b).abs().max())
                          for a, b in zip(got[:2], want[:2]))
                same = bool(torch.equal(got[2], want[2]))
                print(f"[5] cd_steps {kp} {variant} {n}x{d}->{k}: max|err| "
                      f"{err:.3e} (atol 1e-6), active equal {same}, "
                      f"{int(got[2].sum())}/{n} rows active after 8 steps")
                check(err <= 1e-6 and same,
                      f"cd_steps {kp} {variant} at {n}x{d}->{k}")
        sweep_args = (o["z0"], o["R"], o["conv"], o["W"], o["nrm"], 0.1)
        got = C.fused_cd_mod_sweep(*sweep_args, l2=0.2)
        torch.cuda.synchronize()
        want = C.fused_cd_mod_sweep_plain(*sweep_args, l2=0.2)
        err = max(float((a - b).abs().max())
                  for a, b in zip(got[:2], want[:2]))
        rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(got[2:], want[2:]))
        print(f"[5] cd_mod_sweep {n}x{d}->{k}: z/R max|err| {err:.3e} "
              f"(atol 1e-4), zmax/dzmax max rel err {rel:.3e} (rtol 1e-5)")
        check(err <= 1e-4 and rel <= 1e-5, f"cd_mod_sweep at {n}x{d}->{k}")

    # alone at the headline shape; all rows active
    o = cd_operands(N, D, K, seed=1)
    none = torch.zeros_like(o["conv"])
    n_atoms = int((o["nrm"] != 0).sum())
    for kp in ("f32", "bf16"):
        rows[f"cd_steps_{kp}"] = cd_steps_row(o, N, D, K, kp)
    sweep_args = (o["z0"], o["R"], none, o["W"], o["nrm"], 0.1)
    rows["cd_mod_sweep"] = cd_mod_sweep_row(sweep_args, N, D, n_atoms)
    del o, sweep_args
    # and at the training width (phase 6's E-steps, phase 7's
    # dict_learning)
    o = cd_operands(TRAIN_N, TRAIN_D, TRAIN_K, seed=2)
    for kp in ("f32", "bf16"):
        rows[f"cd_steps_{kp}_train"] = cd_steps_row(o, TRAIN_N, TRAIN_D,
                                                    TRAIN_K, kp)
    sweep_args = (o["z0"], o["R"], torch.zeros_like(o["conv"]), o["W"],
                  o["nrm"], 0.1)
    rows["cd_mod_sweep_train"] = cd_mod_sweep_row(
        sweep_args, TRAIN_N, TRAIN_D, int((o["nrm"] != 0).sum()))
    return rows


def cd_steps_row(o, n, d, k, kp):
    """K3 alone on every row of ``cd_operands`` (all active, alpha 0.2, tol
    0, 8 steps) against its plain version (atol 1e-6, the active mask
    equal), timed, with its bound: the bytes of b and z in and out, the
    mask in and out and S once (the operations, about 7 per entry and
    step, take less)."""
    step_args = (o["b"], o["z"], torch.ones_like(o["act"]), o["S"], 0.2, 0.0)
    got = C.fused_cd_steps(*step_args, steps=8, kernel_precision=kp)
    torch.cuda.synchronize()
    want = C.fused_cd_steps_plain(*step_args, steps=8, kernel_precision=kp)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    check(err <= 1e-6 and bool(torch.equal(got[2], want[2])),
          f"cd_steps {kp} at {n}x{d}->{k}")
    nbytes = 4 * (4 * n * k + 2 * n) + (4 if kp == "f32" else 2) * k * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * n * k * 7 / PEAK_FLOPS["f32"] * 1e3
    row = {
        "name": f"cd_steps_{kp}", "shape": f"{n}x{d}->{k}", "route": "cuda",
        "source": CD_SOURCE, "replaces": CD_REPLACES["cd_steps"],
        "launches": None, "max_abs_err": err,
        "ms": cuda_ms(lambda: C.fused_cd_steps(*step_args, steps=8,
                                               kernel_precision=kp)),
        "plain_ms": cuda_ms(lambda: C.fused_cd_steps_plain(
            *step_args, steps=8, kernel_precision=kp), reps=5),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}
    print(f"[5] {json.dumps(row)} (8 steps a launch; no PyTorch call "
          f"computes a greedy CD step: library null)")
    return row


def cd_mod_sweep_row(sweep_args, n, d, n_atoms):
    """K4 alone on every row of ``sweep_args`` against its plain version at
    the kernel's chunk, timed, with its bound: a dot product and a rank-1
    update, 4 D operations, per row and nonzero atom in FP32 FFMA (K4's
    route), or the bytes of z and R in and out and W once."""
    got = C.fused_cd_mod_sweep(*sweep_args)
    torch.cuda.synchronize()
    want = C.fused_cd_mod_sweep_plain(*sweep_args)
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    k = sweep_args[0].shape[1]
    check(err <= 1e-4, f"cd_mod_sweep at {n}x{d}->{k}")
    t_ops = 4 * n * n_atoms * d / PEAK_FLOPS["f32"] * 1e3
    t_bytes = 4 * (2 * n * k + 2 * n * d + k * d + k + 3 * n) \
        / HBM_BYTES_PER_S * 1e3
    row = {
        "name": "cd_mod_sweep", "shape": f"{n}x{d}->{k}", "route": "cuda",
        "source": CD_SOURCE, "replaces": CD_REPLACES["cd_mod_sweep"],
        "launches": None, "max_abs_err": err,
        "ms": cuda_ms(lambda: C.fused_cd_mod_sweep(*sweep_args), reps=10),
        "plain_ms": cuda_ms(lambda: C.fused_cd_mod_sweep_plain(*sweep_args),
                            reps=1, warm=1),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}
    print(f"[5] {json.dumps(row)} (one sweep, its Gram prologue included; "
          f"no PyTorch call computes a cyclic CD sweep: library null)")
    return row


def training_data():
    """Signals with a dictionary to learn: X = Z0 W0^T + 0.1 noise, W0
    [256, 1024] unit atoms, Z0 with 2% nonzeros. (On white noise there is
    nothing to learn: with a 100-step greedy E-step from zero the loss
    then rises from step to step, in the JAX package as in the port.)"""
    rng = np.random.default_rng(2)
    W0 = rng.standard_normal((TRAIN_D, TRAIN_K))
    W0 /= np.linalg.norm(W0, axis=0)
    Z0 = rng.standard_normal((TRAIN_N, TRAIN_K)) * (
        rng.random((TRAIN_N, TRAIN_K)) < 0.02)
    X = Z0 @ W0.T + 0.1 * rng.standard_normal((TRAIN_N, TRAIN_D))
    return X.astype(np.float32)


def phase_train_cli(X_np):
    """The training path through the CLI, with dict_learning wrapped to
    keep its losses; then the E- and M-step times of one step, and one EM
    step on the plain path."""
    seen = {}
    real = linear.dict_learning

    def keep(*a, **kw):
        seen["W"], seen["losses"] = real(*a, **kw)
        return seen["W"], seen["losses"]

    solver = {"algorithm": "cd"}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("X.npy", "W.npy")]
        np.save(paths[0], X_np)
        argv = sys.argv
        sys.argv = ["lasso_tpu_torch", "train", paths[0], "--atoms",
                    str(TRAIN_K), "--alpha", "0.1", "--steps", "3", "-o",
                    paths[1], "--solver-args", json.dumps(solver)]
        linear.dict_learning = keep
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        runpy.run_module("lasso_tpu_torch", run_name="__main__",
                         alter_sys=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        linear.dict_learning = real
        sys.argv = argv
        W_saved = np.load(paths[1])
    losses = seen["losses"].cpu().numpy()
    print("[6] train launch counts:", json.dumps(counts))
    print(f"[6] train: 3 EM steps in {seconds:.3f} s through the CLI "
          f"({3 / seconds:.3f} EM steps/s, data load and init included); "
          f"losses {losses.tolist()}")
    launches = counts.get("cd_steps_f32", 0)
    if launches != 36:
        print(f"[6] {launches} cd_steps launches, not 36: every row of an "
              f"E-step froze before its budget")
    check(0 < launches <= 36 and counts.get("cd_steps_bf16", 0) == 0,
          f"cd_steps launches {launches}")
    check(bool(np.all(np.diff(losses) <= 0)), "losses non-increasing")
    check(np.allclose(np.linalg.norm(W_saved, axis=0), 1.0, atol=1e-5),
          "unit atoms")

    # E-step and M-step of one more step on the trained dictionary: wall
    # time, then the card's kernel time under the profiler
    X = torch.from_numpy(X_np).to(DEV)
    W = torch.from_numpy(W_saved).to(DEV)
    kw = dict(algorithm="cd", maxiter=100, tol=0.0)
    atoms = torch.randn(TRAIN_K, TRAIN_D, device=DEV)
    e_step = lambda: sparse_encode(X, W, 0.1, **kw)  # noqa: E731
    m_step = lambda: DL._update_dict(W, X, Z, atoms)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Z = e_step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    m_step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(Z).all()), "training codes finite")
    busy = [kernel_seconds(f) for f in (e_step, m_step)]
    print(f"[6] one EM step: E-step (greedy CD, 100 steps) {t1 - t0:.4f} s "
          f"wall, {busy[0]:.4f} s of kernels; M-step (sequential, {TRAIN_K} "
          f"atoms) {t2 - t1:.4f} s wall, {busy[1]:.4f} s of kernels")
    b = X @ W
    step_args = (b, torch.zeros_like(b), torch.ones(TRAIN_N, 1, device=DEV),
                 torch.eye(TRAIN_K, device=DEV) - W.T @ W, 0.1, 0.0)
    ms = cuda_ms(lambda: C.fused_cd_steps(*step_args))
    print(f"[6] cd_steps_f32 at {TRAIN_N}x{TRAIN_K}, 8 steps from zero: "
          f"{ms:.4f} ms a launch")

    # one EM step on the plain path against the kernel path
    out = {}
    for use_pallas in ("auto", False):
        _, out[use_pallas] = DL.dict_learning(
            X, TRAIN_K, alpha=0.1, steps=1, use_pallas=use_pallas,
            generator=torch.Generator(device=DEV).manual_seed(0), **kw)
    la, lp = float(out["auto"][0]), float(out[False][0])
    print(f"[6] one EM step, loss with the kernel {la:.8g}, plain "
          f"{lp:.8g} (rtol 1e-4)")
    check(abs(la - lp) <= 1e-4 * abs(lp), "EM loss kernel vs plain")
    return counts


def phase_cd_mod(X_np, x_np, W_np):
    """Cyclic CD: training at the training width, then one solve at the
    headline width held against the plain path. Returns K4's launches at
    each width."""
    X = torch.from_numpy(X_np).to(DEV)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    _, losses = DL.dict_learning(
        X, TRAIN_K, alpha=0.1, steps=2, algorithm="cd-mod", max_iter=20,
        tol=1e-4, dict_update="block",
        generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    train_sweeps = counts.get("cd_mod_sweep", 0)
    print("[7] cd-mod training launch counts:", json.dumps(counts))
    print(f"[7] cd-mod training: 2 EM steps in {seconds:.3f} s "
          f"({seconds / 2:.4f} s an EM step), {train_sweeps} sweeps "
          f"({train_sweeps / seconds:.3f} sweeps/s with the M-steps), "
          f"losses {losses.cpu().numpy().tolist()}")
    check(0 < train_sweeps <= 40
          and bool(torch.isfinite(losses).all()), "cd-mod training")

    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    before = C.CD_MOD_SWEEP.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z, gap, n_iter = coord_descent_mod(x, W, alpha=0.1, max_iter=20,
                                       tol=1e-4, return_iters=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sweeps = C.CD_MOD_SWEEP.launches - before
    print(f"[7] coord_descent_mod {N}x{D}->{K}: {n_iter} sweeps, "
          f"{sweeps} launches, {n_iter / seconds:.3f} sweeps/s "
          f"({seconds:.3f} s, gap checks included), max gap "
          f"{float(gap.max()):.4g}")
    check(sweeps == n_iter and bool(torch.isfinite(gap).all())
          and bool(torch.isfinite(z).all()), "cd-mod at the headline")

    # where a sweep's time goes: K4, the gap check's kernels, the host
    solve = lambda: coord_descent_mod(  # noqa: E731
        x, W, alpha=0.1, max_iter=20, tol=1e-4, return_iters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_iter = solve()[2]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_name = kernel_ms_by_name(solve)
    k4 = sum(v for k, v in by_name.items() if "cd_mod" in k)
    busy = sum(by_name.values())
    print(f"[7] one solve of {n_iter} sweeps: {wall:.3f} ms wall, "
          f"{busy:.3f} ms of kernels (torch.profiler): K4 and its prologue "
          f"{k4:.3f} ms ({k4 / n_iter:.4f} a sweep, {100 * k4 / wall:.1f}% "
          f"of the wall time), the gap check and the rest {busy - k4:.3f} ms "
          f"({(busy - k4) / n_iter:.4f} a sweep), the host "
          f"{wall - busy:.3f} ms; by kernel {json.dumps(by_name)}")

    out = {}
    for use_pallas in ("auto", False):
        out[use_pallas] = coord_descent_mod(
            x, W, alpha=0.1, max_iter=5, tol=1e-4, use_pallas=use_pallas,
            return_iters=True)
    zerr = float((out["auto"][0] - out[False][0]).abs().max())
    gerr = float(((out["auto"][1] - out[False][1]).abs()
                  / out[False][1].abs().clamp_min(1.0)).max())
    print(f"[7] 5 sweeps with the kernel against the plain path: z "
          f"max|err| {zerr:.3e} (atol 1e-4), gap max err {gerr:.3e} "
          f"(relative above 1, 1e-4), n_iter {out['auto'][2]} / "
          f"{out[False][2]}")
    check(zerr <= 1e-4 and gerr <= 1e-4
          and out["auto"][2] == out[False][2], "cd-mod kernel vs plain")
    return {"train": train_sweeps, "headline": sweeps}


def ragged_groups(k, rng):
    """Permuted group ids of sizes 4 and 12 in turn (K/8 groups) and their
    Yuan-Lin weights sqrt(size)."""
    sizes = np.resize([4, 12], k // 8)
    ids = np.repeat(np.arange(k // 8), sizes)[rng.permutation(k)]
    return ids.astype(np.int32), np.sqrt(sizes).astype(np.float32)


def group_codes_objective64(x, W, z, thg, ids):
    """``0.5 ||z W^T - x||^2 + sum_g thg_g ||z_g||`` in float64 on the card,
    the measure by which tests/test_torch_fused_group.py holds two bf16
    group solves that sum in other orders."""
    z64 = z.double()
    r = z64 @ W.double().T - x.double()
    g = torch.as_tensor(ids, dtype=torch.int64, device=z.device)
    sq = torch.zeros(z.shape[0], thg.shape[0], dtype=torch.float64,
                     device=z.device).index_add_(1, g, z64 * z64)
    return float(0.5 * (r * r).sum() + (sq.sqrt() * thg.double()).sum())


def phase_group_kernels():
    """K5 inside 8-sub-step group-FISTA calls against the plain version,
    then alone at the headline shape: time, plain time, bound."""
    rng = np.random.default_rng(8)
    lr, moms = 0.1, torch.linspace(0, 0.6, 8)
    for n, d, k in ((200, 128, 256), (N, D, K)):
        x, W, z, zp, _, tv = operands(n, d, k, seed=n + 8)
        ids, w_g = ragged_groups(k, rng)
        block_ids = np.repeat(np.arange(k // GS), GS)
        blocks = G.build_group_tables(block_ids, k // GS, DEV, block=GS)
        ragged = G.build_group_tables(ids, k // 8, DEV)
        variants = (
            ("blocks", blocks, torch.full((k // GS,), 0.25, device=DEV),
             dict(), block_ids),
            ("ids_yuanlin_l1_restart", ragged,
             0.08 * torch.from_numpy(w_g).to(DEV),
             dict(t_vec=tv, use_l1=True), ids))
        for kp in ("f32", "bf16"):
            rtol = TOL[kp][1]
            for variant, tables, thg, kw, gids in variants:
                args = (x, z, zp, W, lr, thg, 0.01, moms, tables, 8)
                got = G.fused_group_fista_multistep(*args,
                                                    kernel_precision=kp, **kw)
                torch.cuda.synchronize()
                want = G.fused_group_fista_multistep_plain(
                    *args, kernel_precision=kp, **kw)
                err = max(float((a - b).abs().max())
                          for a, b in zip(got[:2], want[:2]))
                dg, dw = float(got[-1]), float(want[-1])
                t_same = "t_vec" not in kw or bool(torch.equal(got[2],
                                                               want[2]))
                zero = float((got[0].reshape(n, -1) == 0).float().mean())
                fg, fw = (group_codes_objective64(x, W, c[0], thg, gids)
                          for c in (got, want))
                print(f"[8] fused_group_fista_multistep {kp} {variant} "
                      f"{n}x{d}->{k}: max|err| {err:.3e} (atol 1e-4 in "
                      f"f32), objective {fg:.10g} vs {fw:.10g} (rtol 1e-4 "
                      f"in bf16), delta {dg:.8g} vs {dw:.8g} (rtol {rtol:g}), "
                      f"t equal {t_same}, zero share {zero:.3f}")
                # f32's products are the bf16x3 split, whose error over 8
                # sub-steps is held as tests/test_torch_fused_group.py holds
                # the same call against JAX's kernel (atol 1e-4,
                # tests/test_group_lasso.py:282-286); bf16 rounds v^2 and
                # each group's scale, and a sum in another order flips some
                # of those roundings and moves whole groups by 2^-8 of their
                # scale, so bf16 is held by its objective (PERF.md, section 6)
                close = (err <= 1e-4 if kp == "f32"
                         else abs(fg - fw) <= 1e-4 * abs(fw))
                check(close and abs(dg - dw) <= rtol * abs(dw)
                      and t_same, f"group multistep {kp} {variant} at "
                      f"{n}x{d}->{k}")
    print("[8] launch counts:", json.dumps(_cuda.launch_counts()))

    # K5 alone at the headline shape: v, z and z_prev as a sub-step sees
    # them, blocks of 8, delta on
    x, W, z, zp, _, tv = operands(N, D, K, seed=88)
    v = z + 0.3 * (zp - z)
    tables = G.build_group_tables(np.repeat(np.arange(K // GS), GS),
                                  K // GS, DEV, block=GS)
    thg = torch.full((K // GS,), 0.25, device=DEV)
    out = torch.empty_like(z)
    rows = {}
    for kp in ("f32", "bf16"):
        got, _ = G.group_prox_update(v, z, zp, None, thg, tables,
                                     kernel_precision=kp, out=out)
        torch.cuda.synchronize()
        want, _, _ = G.group_prox_update_plain(v, z, zp, None, thg, tables,
                                               kernel_precision=kp)
        err = float((got - want).abs().max())
        check(err <= TOL[kp][0], f"group_prox {kp} alone at the headline")
        # bytes: v and z read, z+ written, the tables and delta; about 6
        # operations per entry
        nbytes = 4 * (3 * N * K + K + 2 * (K // GS) + 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 6 * N * K / PEAK_FLOPS["f32"] * 1e3
        rows[kp] = {
            "name": f"group_prox_{kp}", "route": "cuda",
            "source": GROUP_SOURCE, "replaces": GROUP_REPLACES,
            "launches": None, "max_abs_err": err,
            "ms": cuda_ms(lambda: G.group_prox_update(
                v, z, zp, None, thg, tables, kernel_precision=kp, out=out)),
            "plain_ms": cuda_ms(lambda: G.group_prox_update_plain(
                v, z, zp, None, thg, tables, kernel_precision=kp)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        print(f"[8] {json.dumps(rows[kp])} (no PyTorch call computes a "
              f"group shrink: library null)")
    # with restart K5 also reads z_prev and the carry: 4 N K 4 B; inside a
    # multistep call its output is the z_prev it reads from the third
    # sub-step on, so it is timed both ways
    t_r = tv.clone()
    ms = cuda_ms(lambda: G.group_prox_update(v, z, zp, t_r, thg, tables,
                                             out=out))
    zp_alias = zp.clone()
    ms_alias = cuda_ms(lambda: G.group_prox_update(
        v, z, zp_alias, t_r, thg, tables, out=zp_alias))
    bound = 4 * (4 * N * K + 2 * N) / HBM_BYTES_PER_S * 1e3
    print(f"[8] group_prox_f32 with restart: {ms:.4f} ms a launch "
          f"({ms_alias:.4f} ms writing over z_prev), bound {bound:.4f} ms "
          f"(bytes)")
    scal = torch.tensor([lr, 0.0, 0.5, 1.0], device=DEV)
    r_out = torch.empty(N, D, device=DEV)
    ops = F.fista_operands(W, N, "f32")
    k1 = [cuda_ms(lambda: F.fista_resid(x, z, zp, W, scal, t_vec=t_arg,
                                        out=r_out, operands=ops))
          for t_arg in (None, tv)]
    print(f"[8] fista_resid_f32: {k1[0]:.4f} ms a launch with a scalar "
          f"momentum, {k1[1]:.4f} ms with the restart carry")
    # one 8-sub-step f32 call, without and with restart: time, and kernel
    # time by name
    for kw in ({}, {"t_vec": tv}):
        call = lambda: G.fused_group_fista_multistep(  # noqa: E731
            x, z, zp, W, lr, thg, 0.0, moms, tables, 8, **kw)
        ms = cuda_ms(call, reps=5, warm=1)
        print(f"[8] fused_group_fista_multistep f32, 8 sub-steps"
              f"{', restart' if kw else ''}: {ms:.4f} ms a call; kernel ms "
              f"by name {json.dumps(kernel_ms_by_name(call))}")
    return rows


def group_problem():
    """benchmarks/group_bench.py's problem: unit atoms, then the inputs,
    from default_rng(0)."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((D, K)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, W


def group_objective64(x, W, z, alpha=GROUP_ALPHA):
    """The group-lasso objective in float64 on the card (blocks of 8)."""
    zd = z.double()
    r = zd @ W.double().T - x.double()
    g = zd.reshape(z.shape[0], -1, GS)
    return float(0.5 * torch.sum(r * r)
                 + alpha * torch.sum(torch.sqrt(torch.sum(g * g, dim=-1))))


def phase_group_slice(x_np, W_np):
    """The group-lasso path at full width: the API in three precisions
    (the main run of this slice), the unfused check, the CLI, a path and
    screening."""
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    kw = dict(algorithm="group-ista", groups=GS, lr=GROUP_LR, maxiter=200,
              tol=0.0)
    runs = (("f32", dict(kernel_precision="f32")),
            ("mixed", dict(kernel_precision="mixed")),
            ("f32_restart", dict(kernel_precision="f32", restart=True)))
    z_of, f_of = {}, {}
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    for name, extra in runs:
        before = _cuda.launch_counts()
        t0 = time.perf_counter()
        z, n_iter = sparse_encode(x, W, GROUP_ALPHA, return_iters=True,
                                  **kw, **extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = _cuda.launch_counts()
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        check(n_iter == 200 and bool(torch.isfinite(z).all()),
              f"group {name}: n_iter {n_iter}, finite codes")
        z_of[name], f_of[name] = z, group_objective64(x, W, z)
        zero = float((z.reshape(N, -1, GS).abs().sum(-1) == 0).float().mean())
        print(f"[9] group-ista {name}: {200 / seconds:.2f} iterations/s "
              f"({seconds:.4f} s for 200), objective f64 {f_of[name]:.10g}, "
              f"zero-group share {zero:.4f}, launches {json.dumps(delta)}")
    counts = _cuda.launch_counts()
    print("[9] group main-run launch counts:", json.dumps(counts))
    want = {"fused_group_fista_multistep": 24,
            "fista_resid_f32": 425, "fista_grad_prox_f32": 425,
            "group_prox_f32": 425, "fista_resid_bf16": 175,
            "fista_grad_prox_bf16": 175, "group_prox_bf16": 175}
    for key, v in want.items():
        check(counts.get(key, 0) == v, f"{key}: {counts.get(key, 0)} != {v}")

    before = _cuda.launch_counts()
    z_u = sparse_encode(x, W, GROUP_ALPHA, use_pallas=False, **kw)
    torch.cuda.synchronize()
    check(_cuda.launch_counts() == before, "the unfused path launches none")
    f_u = group_objective64(x, W, z_u)
    rel = abs(f_of["f32"] - f_u) / abs(f_u)
    print(f"[9] f32 kernel objective {f_of['f32']:.10g} against the unfused "
          f"path {f_u:.10g}: relative {rel:.3e} (at most 1e-5); codes "
          f"max|err| {float((z_of['f32'] - z_u).abs().max()):.3e}")
    check(rel <= 1e-5, "group f32 kernel objective against unfused")
    z_a = sparse_encode(x, W, GROUP_ALPHA, kernel_precision="f32",
                        **{**kw, "maxiter": 1600})
    f_a = group_objective64(x, W, z_a)
    f_b = group_objective64(x, W, sparse_encode(
        x, W, GROUP_ALPHA, kernel_precision="bf16", **kw))
    gap = 100.0 * (f_of["mixed"] - f_of["f32"]) / max(f_of["f32"] - f_a,
                                                      1e-30)
    # At this lr the f32 solve ends within about 2e-4 relative of its
    # anchor, and bf16 steps leave a floor about 1% above it that a 25-step
    # f32 tail does not remove: the gap is thousands of percent in the JAX
    # package as here (PERF.md, PR 4). Held: the JAX tests' identity
    # f32 <= mixed <= bf16 in objective.
    print(f"[9] 1600-iteration f32 anchor {f_a:.10g}, bf16 {f_b:.10g}; "
          f"mixed gap {gap:.4f}%; restart objective "
          f"{f_of['f32_restart']:.10g}")
    check(f_a <= f_of["f32"] <= f_of["mixed"] * (1 + 1e-7)
          and f_of["mixed"] <= f_b, "group objectives f32 <= mixed <= bf16")

    # serving through the CLI
    rng = np.random.default_rng(9)
    xc = rng.standard_normal((CLI_ROWS, D)).astype(np.float32)
    solver = {"groups": GS, "maxiter": 200, "tol": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("X.npy", "W.npy", "Z.npy")]
        np.save(paths[0], xc)
        np.save(paths[1], W_np)
        argv = sys.argv
        sys.argv = ["lasso_tpu_torch", "encode", paths[0], paths[1], "-o",
                    paths[2], "--alpha", str(GROUP_ALPHA), "--algorithm",
                    "group-ista", "--chunk-size", str(CLI_CHUNK),
                    "--solver-args",
                    json.dumps(solver)]
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        runpy.run_module("lasso_tpu_torch", run_name="__main__",
                         alter_sys=True)
        torch.cuda.synchronize()
        cli_counts = _cuda.launch_counts()
        sys.argv = argv
        zc = np.load(paths[2])
    print("[9] CLI launch counts:", json.dumps(cli_counts))
    for key, v in {"fused_group_fista_multistep": 24, "fista_resid_f32": 600,
                   "fista_grad_prox_f32": 600, "group_prox_f32": 600}.items():
        check(cli_counts.get(key, 0) == v,
              f"CLI {key}: {cli_counts.get(key, 0)} != {v}")
    for lo, hi in ((0, CLI_CHUNK), (2 * CLI_CHUNK, CLI_ROWS)):
        direct = sparse_encode(torch.from_numpy(xc[lo:hi]).to(DEV), W,
                               GROUP_ALPHA, algorithm="group-ista",
                               **solver).cpu().numpy()
        err = float(np.abs(zc[lo:hi] - direct).max())
        print(f"[9] CLI rows {lo}:{hi} against a direct sparse_encode: "
              f"max|err| {err:.3e}")
        check(err <= 1e-5, f"group CLI rows {lo}:{hi}")
    check(zc.shape == (CLI_ROWS, K) and np.isfinite(zc).all(), "CLI codes")

    # a regularization path: 4 alphas at PATH_N rows as one batched solve
    alphas = [0.05, 0.1, 0.2, 0.4]
    pkw = dict(algorithm="group-ista", groups=GS, lr=GROUP_LR, maxiter=100,
               tol=0.0)
    before = G.GROUP_PROX["f32"].launches
    t0 = time.perf_counter()
    zp = lasso_path(x[:PATH_N], W, alphas, mode="batched", **pkw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    nz = [float((zp[i].reshape(PATH_N, -1, GS).abs().sum(-1) != 0).float()
                .mean()) for i in range(4)]
    direct = sparse_encode(x[:PATH_N], W, 0.1, **pkw)
    err = float((zp[1] - direct).abs().max())
    print(f"[9] lasso_path batched, alphas {alphas} at N={PATH_N}: "
          f"{seconds:.4f}"
          f" s, group_prox_f32 launches "
          f"{G.GROUP_PROX['f32'].launches - before}, nonzero-group share "
          f"{[round(v, 4) for v in nz]}, alpha 0.1 against a direct solve "
          f"max|err| {err:.3e} (atol 1e-4)")
    check(tuple(zp.shape) == (4, PATH_N, K)
          and bool(torch.isfinite(zp).all())
          and all(a >= b for a, b in zip(nz, nz[1:])) and err <= 1e-4,
          "group lasso_path")

    # gap-safe screening through chunked_encode at an alpha that screens
    infos = []
    real = SCR.screened_encode

    def keep_info(*a, **k):
        z, info = real(*a, **k)
        infos.append(info)
        return z, info

    xs = x_np[:SCREEN_ROWS]
    skw = dict(chunk_size=SCREEN_CHUNK, maxiter=1000, tol=1e-10)
    SCR.screened_encode = keep_info
    t0 = time.perf_counter()
    z_s = chunked_encode(xs, W, alpha=3.5, screen=True,
                         screen_kwargs=dict(warm_iters=10), **skw)
    s_seconds = time.perf_counter() - t0
    SCR.screened_encode = real
    t0 = time.perf_counter()
    z_p = chunked_encode(xs, W, alpha=3.5, **skw)
    p_seconds = time.perf_counter() - t0
    err = float(np.abs(z_s - z_p).max())
    print(f"[9] chunked_encode(screen=True) at alpha 3.5, {SCREEN_ROWS} rows "
          f"in chunks of {SCREEN_CHUNK}: kept/K "
          f"{[(i['kept'], i['K']) for i in infos]}, screened "
          f"{[i['screened'] for i in infos]}, {s_seconds:.3f} s against "
          f"{p_seconds:.3f} s unscreened, max|err| {err:.3e} (atol 1e-4)")
    check(len(infos) == SCREEN_ROWS // SCREEN_CHUNK
          and all(i["screened"] for i in infos)
          and err <= 1e-4, "screened chunked encode")
    return counts


def omp_codes(idx, z_s, k):
    """The [N, k] codes of a support and its coefficients."""
    z = torch.zeros((idx.shape[0], k), device=z_s.device)
    return z.scatter_add_(1, idx.long(), z_s)


def omp_rss64(x, W, z):
    """Per-row squared residual in float64 on the card."""
    r = x.double() - z.double() @ W.double().T
    return torch.sum(r * r, dim=1)


def omp_equivalent(x, W, za, zb):
    """The JAX tests' rule for two OMP fits (tests/test_fused_omp.py:31-43):
    codes within 2e-4 on the rows whose supports agree; on the rows where
    a near-tie flipped an atom, the per-row rss within 1e-3 relative (plus
    1e-5). Returns (ok, share of rows with equal supports, max code error
    there, max rss error elsewhere, the rows that part)."""
    same = torch.all((za != 0) == (zb != 0), dim=1)
    err = float((za[same] - zb[same]).abs().max()) if bool(same.any()) \
        else 0.0
    ra, rb = omp_rss64(x, W, za)[~same], omp_rss64(x, W, zb)[~same]
    rel = float(((ra - rb).abs() / (1e-3 * ra.abs() + 1e-5)).max()) \
        if bool((~same).any()) else 0.0
    return (err <= 2e-4 and rel <= 1.0, float(same.float().mean()), err,
            rel * 1e-3, torch.nonzero(~same)[:, 0])


def omp_certificate(x, W, z, rows, kp="f32"):
    """Whether each of ``rows`` of the codes z is an OMP solution up to
    near-ties, in float64: some order of the row's support must take, at
    every step, an atom that scores within a relative ``eps`` of the best
    unselected atom on the least-squares residual of the atoms before it
    (where two support atoms tie, both orders are tried), and the codes
    must be the least-squares fit on the support. ``eps`` is
    ``CERT_EPS[kp]``; with ``kp='bf16'`` the scores are those of the bf16
    selection: the residual and W rounded to bf16, the products summed in
    float64. The depth-first search over
    orders stops after 4 |support| visits; a row that runs out counts as
    failed (gap 1.0), so the limit bounds the check's time and can only
    fail a row, never pass one. Returns (the largest gap of the orders
    found, the largest code error). The solves here are the check's own
    float64 reference."""
    eps = CERT_EPS[kp]
    W64 = W.double()
    Ws = (W.to(torch.bfloat16) if kp == "bf16" else W).double()
    inv = 1.0 / W64.norm(dim=0)
    gap, cerr = 0.0, 0.0
    for i in rows.tolist():
        x64 = x[i].double()
        support = torch.nonzero(z[i])[:, 0].tolist()
        budget = [4 * len(support)]

        def fit(chosen):
            Wc = W64[:, chosen]
            return torch.linalg.solve(Wc.T @ Wc, Wc.T @ x64)

        def search(chosen, worst):
            """An eps-greedy order extending ``chosen``, or None."""
            if len(chosen) == len(support):
                return worst
            budget[0] -= 1
            if budget[0] < 0:
                return None
            r = x64 - W64[:, chosen] @ fit(chosen) if chosen else x64
            if kp == "bf16":
                r = r.float().to(torch.bfloat16).double()
            score = (r @ Ws).abs() * inv
            score[chosen] = -1.0
            best = float(score.max())
            cands = sorted((a for a in support if a not in chosen),
                           key=lambda a: -float(score[a]))
            for a in cands:
                g = (best - float(score[a])) / best
                if g > eps:
                    break
                found = search(chosen + [a], max(worst, g))
                if found is not None:
                    return found
            return None

        found = search([], 0.0)
        gap = max(gap, 1.0 if found is None else found)
        cerr = max(cerr, float((z[i, support].double() - fit(support))
                               .abs().max()))
    return gap, cerr


def omp_agree_at_scale(x, W, za, zb, label, kp="f32"):
    """Two OMP fits at the headline width, selecting in ``kp``: codes
    within 2e-4 on the rows whose supports agree, and at most
    ``OMP_PARTING`` rows that part, each of them in both fits an OMP
    solution up to near-ties (``omp_certificate``: gap at most
    ``CERT_EPS[kp]``, codes within 2e-4 of the float64 least-squares
    fit). The JAX tests' rss fallback is printed: at T=64 two greedy paths
    that part at a near-tie go on apart for the remaining steps, and their
    rss can differ by more than its 1e-3."""
    ok, share, err, rel, part = omp_equivalent(x, W, za, zb)
    n_part = len(part)
    cert = [omp_certificate(x, W, z, part, kp) if n_part <= OMP_PARTING
            else (1.0, 1.0) for z in (za, zb)]
    gap, cerr = max(c[0] for c in cert), max(c[1] for c in cert)
    print(f"[{label}] supports equal on {share:.6f} of rows, codes max|err| "
          f"{err:.3e} (2e-4); {n_part} rows part (at most {OMP_PARTING}): "
          f"largest {kp} near-tie gap {gap:.3e} ({CERT_EPS[kp]:g}), codes "
          f"against their float64 least-squares fit {cerr:.3e} (2e-4); the "
          f"JAX tests' rss rule on those rows "
          f"{'holds' if ok else 'does not hold'}: rss max "
          f"rel err {rel:.3e} (1e-3)")
    return (err <= 2e-4 and n_part <= OMP_PARTING and gap <= CERT_EPS[kp]
            and cerr <= 2e-4)


def omp_case(n, d, k, T, seed, duplicate=False):
    """Unit atoms (with ``duplicate`` each odd atom a copy of the even one
    before it, which the zero rows select in turn), x with 16 rows 3-sparse
    over W (they freeze under tol at step 3) and 8 zero rows (frozen at
    step 0 under tol)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    W = torch.randn(d, k, generator=g, device=DEV)
    if duplicate:
        W[:, 1::2] = W[:, ::2]
    W = W / W.norm(dim=0)
    x = torch.randn(n, d, generator=g, device=DEV)
    zt = torch.zeros(16, k, device=DEV)
    zt[:, 3:6] = torch.randn(16, 3, generator=g, device=DEV)
    x[:16] = zt @ W.T
    x[16:24] = 0.0
    return x, W


def graph_ms(fn, reps=3):
    """Card time of one call of ``fn`` without its host share: the call's
    launches captured once in a CUDA graph, then the mean of ``reps``
    replays between two events. For plain versions made of many small
    PyTorch ops, which Python enqueues more slowly than the card runs
    them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    del graph
    return e0.elapsed_time(e1) / reps


def clone_state(state):
    """A copy of a fused OMP solve's state."""
    return O.OmpState(**{f.name: getattr(state, f.name).clone()
                         for f in dataclasses.fields(O.OmpState)})


def timed_fused_solve(x, W, T, kp, gs="mgs"):
    """One fused OMP solve through its three kernels, with CUDA events
    around every launch, enqueued behind ``hold_the_card``. Returns (the
    final state, the codes [N, K], per-step select ms, per-step orth ms,
    backsub ms)."""
    invn, wt = O.inverse_norms(W), W.T.contiguous()
    wsplit = O.select_operands(W, kp)
    state = O.omp_init_state(x, W.shape[1], T)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2 * T + 2)]
    hold_the_card()
    for k in range(T):
        ev[2 * k].record()
        O.omp_select(state, wsplit, invn, kp)
        ev[2 * k + 1].record()
        O.omp_orth(state, wt, k, gs=gs)
    ev[2 * T].record()
    z_t = O.omp_backsub(state)
    ev[2 * T + 1].record()
    torch.cuda.synchronize()
    sel_ms = [ev[2 * k].elapsed_time(ev[2 * k + 1]) for k in range(T)]
    orth_ms = [ev[2 * k + 1].elapsed_time(ev[2 * k + 2]) for k in range(T)]
    z_s = torch.where(state.valid > 0, z_t, 0.0)
    return (state, omp_codes(state.idx, z_s, W.shape[1]), sel_ms, orth_ms,
            ev[2 * T].elapsed_time(ev[2 * T + 1]))


def rel_excess(a, c, rtol):
    """max(|a - c| - rtol |c|): at most atol where a and c agree within
    rtol / atol."""
    return float(((a - c).abs() - rtol * c.abs()).max())


def pd_rows(B_, T, seed):
    """The Gram rows and right-hand sides of B_ random PD systems
    M = A A^T / T + I, [T, T, B_] and [T, B_], every fifth system the
    identity (a frozen OMP sample appends identity rows)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    A = torch.randn(B_, T, T, generator=g, device=DEV)
    M = A @ A.transpose(1, 2) / T + torch.eye(T, device=DEV)
    M[::5] = torch.eye(T, device=DEV)
    return M.permute(1, 2, 0).contiguous(), torch.randn(
        T, B_, generator=g, device=DEV)


def append_rows(M, rhs, k):
    """Row k of the systems and the first k + 1 entries of rhs, zero
    beyond, as the OMP step gives them."""
    g = M[k].clone()
    g[k + 1:] = 0.0
    b = rhs.clone()
    b[k + 1:] = 0.0
    return g, b


def backsub_case(n, T, aligned, seed):
    """An OMP state holding only what K6c reads: R with well-conditioned
    upper-triangular systems by columns (NaN past each diagonal, which K6c
    never reads), every fourth sample frozen from slot T // 3 on (columns
    e_j, d_j = 0, not valid), a fifth of the other slots not valid; R one
    float past a 16-byte boundary unless ``aligned``."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    Rm = torch.randn(n, T, T, generator=g, device=DEV) / T
    jj = torch.arange(T, device=DEV)
    Rm[:, jj, jj] = 1.0 + torch.randn(n, T, generator=g, device=DEV).abs()
    Rm[:, jj[:, None] < jj[None, :]] = float("nan")
    d = torch.randn(n, T, generator=g, device=DEV)
    valid = (torch.rand(n, T, generator=g, device=DEV) > 0.2).float()
    frozen = torch.arange(n, device=DEV) % 4 == 0
    f0 = T // 3
    Rm[frozen, f0:] = torch.where(jj[None, :] <= jj[f0:, None],
                                  torch.eye(T, device=DEV)[f0:], Rm[frozen,
                                                                    f0:])
    d[frozen, f0:] = 0.0
    valid[frozen, f0:] = 0.0
    buf = torch.empty(n * T * T + 1, device=DEV)
    R = buf[int(not aligned):][:n * T * T].view(n, T, T)
    R.copy_(Rm)
    return O.OmpState(r=d, rb=None, sel=None, active=None, Q=None, R=R, d=d,
                      valid=valid, idx=None, pval=None, pidx=None)


def phase_omp_kernels():
    """K6 (fused OMP: omp_select, omp_orth, omp_orth_cgs2, omp_backsub)
    and K7 (chol_append_solve) against their plain versions on the card,
    then each alone at the headline width: time, plain time, bound."""
    for (n, d, k, T, kp, tol, dup), gs in itertools.product((
            (1000, 256, 512, 13, "f32", None, False),
            (1000, 256, 512, 13, "bf16", None, False),
            (1000, 256, 512, 16, "f32", 1e-4, False),
            (1000, 256, 512, 16, "f32", None, True)), ("mgs", "cgs2")):
        x, W = omp_case(n, d, k, T, seed=n + T, duplicate=dup)
        got = O.fused_omp_solve(x, W, T, tol=tol, kernel_precision=kp,
                                gs=gs)
        torch.cuda.synchronize()
        want = O.fused_omp_solve_plain(x, W, T, tol=tol, kernel_precision=kp,
                                       gs=gs)
        za, zb = omp_codes(want[0], want[2], k), omp_codes(got[0], got[2], k)
        ok, share, err, rel, _ = omp_equivalent(x, W, za, zb)
        if dup:
            # a dependent pair's weight split follows the pivot floor's
            # rounding (tests/test_fused_omp.py holds such dictionaries to
            # finite codes and the fitted residual): rss on every row
            ra, rb = omp_rss64(x, W, za), omp_rss64(x, W, zb)
            rel = float(((ra - rb).abs() / (1e-3 * ra + 1e-5)).max()) * 1e-3
            ok = rel <= 1e-3
        frozen = int((~got[1][:, -1]).sum())
        v_same = bool(torch.equal(got[1], want[1]))
        finite = bool(torch.isfinite(got[2]).all())
        print(f"[10] fused_omp_solve {kp} gs={gs} {n}x{d}->{k} T={T} "
              f"tol={tol} duplicated={dup}: supports equal on {share:.4f} "
              f"of rows, "
              f"codes max|err| {err:.3e} ({'not held' if dup else '2e-4'}), "
              f"rss max rel err {rel:.3e} (1e-3{', every row' if dup else ''}"
              f"), valid equal {v_same}, {frozen} rows frozen, finite "
              f"{finite}")
        check(ok and v_same and finite and (tol is None or frozen >= 24),
              f"fused OMP {kp} gs={gs} T={T} tol={tol} duplicated={dup}")
    for T, B_ in ((16, 1000), (64, 1000), (72, 100)):
        M, rhs = pd_rows(B_, T, seed=T)
        V = torch.eye(T, device=DEV)[:, :, None].repeat(1, 1, B_)
        Vp = V.clone()
        worst = 0.0
        for kk in range(T):
            g, b = append_rows(M, rhs, kk)
            fresh, z_f = B.cholesky_append_solve_lanes(V, g, b, kk)
            _, z = B.cholesky_append_solve_lanes(V, g, b, kk, out=V)
            Vp, z_p = B.cholesky_append_solve_lanes_plain(Vp, g, b, kk)
            for a, c in ((V, Vp), (fresh, Vp), (z, z_p), (z_f, z_p)):
                worst = max(worst, rel_excess(a, c, 2e-4))
        print(f"[10] chol_append_solve T={T} B={B_} ({B.append_tier(T, B_)} "
              f"tier), {T} appends in place and into a new factor: "
              f"max(|err| - 2e-4 |plain|) {worst:.3e} (atol 1e-5)")
        check(worst <= 1e-5, f"chol_append_solve T={T}")
    for n_, T, aligned in ((1001, 64, False), (45, 136, True)):
        state = backsub_case(n_, T, aligned, seed=T)
        same = bool(torch.equal(O.omp_backsub(state),
                                O.omp_backsub_plain(state)))
        print(f"[10] omp_backsub N={n_} T={T} ({O.backsub_tier(state)} "
              f"tier), frozen samples: bit for bit {same}")
        check(same, f"omp_backsub T={T}")
    print("[10] launch counts:", json.dumps(_cuda.launch_counts()))

    # at the headline width: one solve with events around every launch in
    # each precision, held to the plain solve by the headline rule
    x, W = (torch.from_numpy(a).to(DEV) for a in omp_problem())
    nK = K // O.TILE
    rows = {}
    solve = {(kp, gs): timed_fused_solve(x, W, OMP_T, kp, gs)
             for kp, gs in (("f32", "mgs"), ("bf16", "mgs"), ("f32", "cgs2"))}
    for (kp, gs), (_, codes, *_) in solve.items():
        idx, _, z_s = O.fused_omp_solve_plain(x, W, OMP_T, kernel_precision=kp,
                                              gs=gs)
        print(f"[10] fused OMP {kp} gs={gs} at {N}x{D}->{K} T={OMP_T}, "
              f"kernels against plain versions:")
        check(omp_agree_at_scale(x, W, omp_codes(idx, z_s, K), codes, 10, kp),
              f"fused OMP {kp} gs={gs} at the headline against the plain "
              f"version")
        del idx, z_s
    invn, wt = O.inverse_norms(W), W.T.contiguous()
    # K6a at step 0: the partials against the plain version's (rtol 1e-5,
    # atol 1e-6). It reads r's and W^T's bf16 parts (hi and lo in f32, hi
    # in bf16), invn and the mask, and writes the partials; its operations
    # are 2 N D K bf16 ones on the tensor cores a product, three products
    # in f32 (the bf16x3 split, the least time for this f32-grade work).
    # Its plain version does the same work at every step: timed once.
    state = O.omp_init_state(x, K, OMP_T)
    for kp in ("f32", "bf16"):
        lib = torch.bfloat16 if kp == "bf16" else torch.float32
        rb, Wb = state.r.to(lib), W.to(lib)
        wsplit = O.select_operands(W, kp)
        O.omp_select(state, wsplit, invn, kp)
        got_v, got_i = state.pval.clone(), state.pidx.clone()
        O.omp_select_plain(state, wsplit, invn, kp)
        e = float((got_v - state.pval).abs().max())
        worst = rel_excess(got_v, state.pval, 1e-5)
        same_i = float((got_i == state.pidx).float().mean())
        parts, products = (2, 3) if kp == "f32" else (1, 1)
        t_bytes = (2 * parts * (N * D + D * K) + 4 * K + N * K
                   + 8 * N * nK) / HBM_BYTES_PER_S * 1e3
        t_ops = products * 2 * N * D * K / PEAK_FLOPS["bf16"] * 1e3
        rows[f"omp_select_{kp}"] = {
            "name": f"omp_select_{kp}", "route": "cuda",
            "source": OMP_SOURCE, "replaces": OMP_REPLACES,
            "launches": None, "max_abs_err": e,
            "ms": sum(solve[kp, "mgs"][2]) / OMP_T,
            "plain_ms": graph_ms(lambda: O.omp_select_plain(state, wsplit,
                                                            invn, kp)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(lambda: torch.matmul(rb, Wb))}
        print(f"[10] {json.dumps(rows[f'omp_select_{kp}'])} (ms: mean of "
              f"the {OMP_T} launches of one solve; plain_ms: CUDA-graph "
              f"replays; bound: {products} bf16 product(s) on the tensor "
              f"cores; library: torch.matmul r W in {lib}; max_abs_err: "
              f"the step-0 partial scores, max(|err| - 1e-5 |plain|) "
              f"{worst:.3e} (atol 1e-6), atoms equal on {same_i:.6f})")
        check(worst <= 1e-6, f"omp_select_{kp} partials at the headline")
    del state, rb, Wb
    # K6b and K6d at step T / 2 from one state: the kernel on it, the
    # plain version on a copy; idx, valid, the masks equal, r, q_k, R's
    # column, d_k and r's kept split (hi + lo) at rtol 2e-4 / atol 1e-5
    k2 = OMP_T // 2
    wsplit = O.select_operands(W)
    for gs, name in (("mgs", "omp_orth"), ("cgs2", "omp_orth_cgs2")):
        st = O.omp_init_state(x, K, OMP_T)
        for kk in range(k2):
            O.omp_select(st, wsplit, invn)
            O.omp_orth(st, wt, kk, gs=gs)
        O.omp_select(st, wsplit, invn)
        twin = clone_state(st)
        O.omp_orth(st, wt, k2, gs=gs)
        O.omp_orth_plain(twin, wt, k2, gs=gs)
        exact = all(torch.equal(a, c) for a, c in (
            (st.idx[:, k2], twin.idx[:, k2]),
            (st.valid[:, k2], twin.valid[:, k2]),
            (st.active, twin.active), (st.sel, twin.sel)))
        pairs = ((st.r, twin.r), (st.Q[:, k2], twin.Q[:, k2]),
                 (st.R[:, k2, :k2 + 1], twin.R[:, k2, :k2 + 1]),
                 (st.d[:, k2], twin.d[:, k2]),
                 (st.rb.float().sum(0), twin.rb.float().sum(0)))
        e_orth = max(float((a - c).abs().max()) for a, c in pairs)
        worst = max(rel_excess(a, c, 2e-4) for a, c in pairs)
        del st, twin, pairs
        check(exact and worst <= 1e-5, f"{name} at step {k2}")
        # ms and bound are means over the steps of the f32 solve: at step
        # k it reads the partials, r, k rows of Q, the atom (W^T once),
        # writes r, r's split, q_k, R column k and the per-row slots; 4 k D
        # + 6 D ops a row with MGS, 8 k D + 6 D with CGS2. Its plain
        # version at every step on a copy of the final state.
        kern = solve["f32", gs]
        scratch = clone_state(kern[0])
        plain_orth = [graph_ms(lambda: O.omp_orth_plain(scratch, wt, kk,
                                                        gs=gs))
                      for kk in range(OMP_T)]
        del scratch
        nbytes = sum(4 * (N * (3 * D + kk * D + D + kk + 1 + 4) + K * D)
                     + 8 * N * nK + N for kk in range(OMP_T)) / OMP_T
        per_k = 4 if gs == "mgs" else 8
        ops = sum(N * (per_k * kk * D + 6 * D)
                  for kk in range(OMP_T)) / OMP_T
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FLOPS["f32"] * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": OMP_SOURCE,
            "replaces": OMP_REPLACES, "launches": None,
            "max_abs_err": e_orth, "ms": sum(kern[3]) / OMP_T,
            "plain_ms": sum(plain_orth) / OMP_T,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        print(f"[10] {json.dumps(rows[name])} (means over the {OMP_T} "
              f"steps of one f32 solve; at steps 0, {k2}, {OMP_T - 1}: "
              f"{kern[3][0]:.4f}, {kern[3][k2]:.4f}, {kern[3][-1]:.4f} ms, "
              f"plain {plain_orth[0]:.4f}, {plain_orth[k2]:.4f}, "
              f"{plain_orth[-1]:.4f} ms (CUDA-graph replays); max_abs_err: "
              f"r, q_k, R's column, d_k and r's split at step {k2} from one "
              f"state, max(|err| - 2e-4 |plain|) {worst:.3e} (atol 1e-5), "
              f"idx, valid and masks equal {exact}; no PyTorch call does "
              f"Gram-Schmidt with the freeze: library null)")
    # K6c on the f32 solve's final state, bit for bit its plain version,
    # and the library's triangular solve: R's upper triangle, d and valid
    # read, z written. The state keeps R transposed (row j holds column j),
    # a lower triangle: z^T L = d^T. ms: the mean of 20 launches on it.
    kern = solve["f32", "mgs"]
    fin = kern[0]
    valid = fin.valid > 0
    z_k, z_p = O.omp_backsub(fin), O.omp_backsub_plain(fin)
    e_back = float((z_k - z_p).abs().max())
    exact = bool(torch.equal(z_k, z_p))
    check(exact, "omp_backsub at the headline, bit for bit")

    def library_backsub():
        return torch.linalg.solve_triangular(fin.R, fin.d[:, None, :],
                                             upper=False, left=False)[:, 0]

    e_lib = float((torch.where(valid, library_backsub(), 0.0) - z_k)
                  .abs().max())
    t_bytes = 4 * N * (OMP_T * (OMP_T + 1) // 2 + 3 * OMP_T) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = N * OMP_T * (OMP_T + 1) / PEAK_FLOPS["f32"] * 1e3
    rows["omp_backsub"] = {
        "name": "omp_backsub", "route": "cuda", "source": OMP_SOURCE,
        "replaces": OMP_REPLACES, "launches": None, "max_abs_err": e_back,
        "ms": cuda_ms(lambda: O.omp_backsub(fin)),
        "plain_ms": graph_ms(lambda: O.omp_backsub_plain(fin)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": cuda_ms(library_backsub)}
    print(f"[10] {json.dumps(rows['omp_backsub'])} ({O.backsub_tier(fin)} "
          f"tier; one launch a solve, {kern[4]:.4f} ms in the timed solve; "
          f"plain_ms: CUDA-graph replays; max_abs_err: z on the f32 solve's "
          f"state, bit for bit {exact}; library: "
          f"torch.linalg.solve_triangular on the same R and d, timed only, "
          f"{e_lib:.3e} from the kernel)")
    del solve, kern, fin, z_k, z_p

    # K7 at B = N, T = 64: the appends of one solve from the identity, in
    # place, each timed with events; the plain version step by step on its
    # own factor (rtol 2e-4 / atol 1e-5), timed by graph replays
    M, rhs = pd_rows(N, OMP_T, seed=7)
    gb = [append_rows(M, rhs, kk) for kk in range(OMP_T)]
    del M
    V = torch.eye(OMP_T, device=DEV)[:, :, None].repeat(1, 1, N)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(OMP_T + 1)]
    z_k = []
    hold_the_card()
    ev[0].record()
    for kk, (g, b) in enumerate(gb):
        V, z = B.cholesky_append_solve_lanes(V, g, b, kk, out=V)
        ev[kk + 1].record()
        z_k.append(z)
    torch.cuda.synchronize()
    ms_k = [ev[kk].elapsed_time(ev[kk + 1]) for kk in range(OMP_T)]
    Vp = torch.eye(OMP_T, device=DEV)[:, :, None].repeat(1, 1, N)
    err, worst, pms_k = 0.0, 0.0, []
    for kk, (g, b) in enumerate(gb):
        pms_k.append(graph_ms(
            lambda: B.cholesky_append_solve_lanes_plain(Vp, g, b, kk)))
        Vp, z_p = B.cholesky_append_solve_lanes_plain(Vp, g, b, kk)
        err = max(err, float((z_k[kk] - z_p).abs().max()))
        worst = max(worst, rel_excess(z_k[kk], z_p, 2e-4))
    err = max(err, float((V - Vp).abs().max()))
    worst = max(worst, rel_excess(V, Vp, 2e-4))
    del z_k, Vp
    check(worst <= 1e-5, f"chol_append_solve at B={N}")
    # step T / 2 again: in place, and into a new factor (the wrapper with
    # no out: a copy of V, then the in-place launch)
    g2, b2 = gb[k2]
    in_place = cuda_ms(lambda: B.cholesky_append_solve_lanes(
        V, g2, b2, k2, out=V))
    new_factor = cuda_ms(lambda: B.cholesky_append_solve_lanes(V, g2, b2, k2))
    # the live block: V's lower triangle in rows < k, g and b to k, row k
    # and z written; y, u, t and z take 2 (k(k+1) + (k+1)(k+2)) ops a row
    nbytes = sum(4 * N * (kk * (kk + 1) // 2 + 2 * (kk + 1) + 2 * OMP_T)
                 for kk in range(OMP_T)) / OMP_T
    ops = sum(2 * N * (kk * (kk + 1) + (kk + 1) * (kk + 2))
              for kk in range(OMP_T)) / OMP_T
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS["f32"] * 1e3
    rows["chol_append_solve"] = {
        "name": "chol_append_solve", "route": "cuda", "source": CHOL_SOURCE,
        "replaces": CHOL_REPLACES, "launches": None,
        "max_abs_err": err, "ms": sum(ms_k) / OMP_T,
        "plain_ms": sum(pms_k) / OMP_T, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}
    print(f"[10] {json.dumps(rows['chol_append_solve'])} (means over the "
          f"{OMP_T} appends from the identity at B={N}; at steps 0, {k2}, "
          f"{OMP_T - 1}: {ms_k[0]:.4f}, {ms_k[k2]:.4f}, {ms_k[-1]:.4f} ms; "
          f"plain_ms: CUDA-graph replays; max_abs_err: z of every step and "
          f"the final V, max(|err| - 2e-4 |plain|) {worst:.3e} (atol 1e-5); "
          f"no PyTorch call appends to an inverse factor: library null)")
    print(f"[10] chol_append_solve at k={k2}: {in_place:.4f} ms in place "
          f"(row k written), {new_factor:.4f} ms into a new factor (a copy "
          f"of V, then the in-place launch)")
    return rows


def omp_problem():
    """benchmarks/omp_fused_bench.py's problem: unit atoms, then the first
    input, from default_rng(0)."""
    rng = np.random.default_rng(0)
    W = rng.standard_normal((D, K)).astype(np.float32)
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    x = rng.standard_normal((N, D)).astype(np.float32)
    return x, W


def phase_omp_slice(x_np, W_np):
    """The OMP slice at full width through sparse_encode: 'auto' (the
    fused kernels), 'fused' in bf16, 'chol' (the append kernel) and 'auto'
    with a tol freeze (the main run of this slice, launches counted), then
    the CLI in chunks."""
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    kw = dict(algorithm="omp", n_nonzero_coefs=OMP_T)
    runs = (("auto", {}), ("fused_bf16", dict(solver="fused",
                                              kernel_precision="bf16")),
            ("chol", dict(solver="chol")), ("auto_tol", None))
    want = {"auto": {"fused_omp_solve": 1, "omp_select_f32": OMP_T,
                     "omp_orth": OMP_T, "omp_backsub": 1},
            "fused_bf16": {"fused_omp_solve": 1, "omp_select_bf16": OMP_T,
                           "omp_orth": OMP_T, "omp_backsub": 1},
            "chol": {"chol_append_solve": OMP_T}}
    z_of, rss_of = {}, {}
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    for name, extra in runs:
        if extra is None:
            # a threshold that about half of the rows reach before T steps
            tol = float(torch.quantile(rss_of["auto"].float(), 0.5)) * 1.05
            extra = dict(tol=tol)
        before = _cuda.launch_counts()
        t0 = time.perf_counter()
        z, n_iter = sparse_encode(x, W, return_iters=True, **kw, **extra)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = _cuda.launch_counts()
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        nnz = (z != 0).sum(dim=1)
        z_of[name], rss_of[name] = z, omp_rss64(x, W, z)
        print(f"[11] omp {name}: {1 / seconds:.3f} solves/s ({seconds:.4f} s,"
              f" {seconds / OMP_T * 1e3:.3f} ms a step), n_iter {n_iter}, "
              f"mean rss {float(rss_of[name].mean()):.6f}, nnz per row "
              f"{int(nnz.min())}-{int(nnz.max())}, launches "
              f"{json.dumps(delta)}")
        check(int(nnz.max()) <= OMP_T and bool(torch.isfinite(z).all())
              and tuple(z.shape) == (N, K), f"omp {name}: codes")
        for key, v in want.get(name, {}).items():
            check(delta.get(key, 0) == v,
                  f"omp {name} {key}: {delta.get(key, 0)} != {v}")
        if name == "auto_tol":
            frozen = nnz < OMP_T
            over = float((rss_of[name][frozen] / tol).max())
            print(f"[11] tol {tol:.6g}: {int(frozen.sum())} of {N} rows "
                  f"froze before {OMP_T} atoms, their rss at most "
                  f"{over:.6f} x tol")
            check(0 < int(frozen.sum()) < N and over <= 1 + 1e-3
                  and n_iter == OMP_T and delta.get("omp_select_f32") == OMP_T,
                  "omp tol freeze")
    counts = _cuda.launch_counts()
    print("[11] omp main-run launch counts:", json.dumps(counts))
    print("[11] fused against chol:")
    check(omp_agree_at_scale(x, W, z_of["chol"], z_of["auto"], 11),
          "fused and chol agree at the headline")
    rel_bf16 = abs(float(rss_of["fused_bf16"].mean() / rss_of["auto"].mean())
                   - 1.0)
    print(f"[11] bf16 selection: mean rss {rel_bf16:.3e} relative from f32's "
          f"(at most 5e-2)")
    check(rel_bf16 <= 5e-2, "bf16 mean rss within 5e-2 of f32's")

    # gs='cgs2' through the fused solve's entry (the solver passes no gs,
    # as the JAX package's), counts set to 0 just before and read after:
    # 64 K6d launches and no K6b; held to the 'mgs' solve ('auto' above)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    idx, valid, z_s = O.fused_omp_solve(x, W, OMP_T, gs="cgs2")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cg_counts = _cuda.launch_counts()
    z = omp_codes(idx, z_s, K)
    print(f"[11] omp gs=cgs2: {1 / seconds:.3f} solves/s ({seconds:.4f} s, "
          f"{seconds / OMP_T * 1e3:.3f} ms a step), mean rss "
          f"{float(omp_rss64(x, W, z).mean()):.6f}, launches "
          f"{json.dumps({k: v for k, v in cg_counts.items() if v})}")
    check(bool(torch.isfinite(z).all()) and int(valid.sum(1).max()) <= OMP_T,
          "omp gs=cgs2: codes")
    for key, v in {"fused_omp_solve": 1, "omp_select_f32": OMP_T,
                   "omp_orth_cgs2": OMP_T, "omp_orth": 0,
                   "omp_backsub": 1}.items():
        check(cg_counts.get(key, 0) == v,
              f"omp gs=cgs2 {key}: {cg_counts.get(key, 0)} != {v}")
    counts["omp_orth_cgs2"] = cg_counts["omp_orth_cgs2"]
    print("[11] cgs2 against mgs:")
    check(omp_agree_at_scale(x, W, z_of["auto"], z, 11),
          "cgs2 and mgs agree at the headline")
    del idx, valid, z_s, z

    # serving through the CLI, in chunks of CLI_CHUNK rows
    rng = np.random.default_rng(11)
    xc = rng.standard_normal((CLI_ROWS, D)).astype(np.float32)
    solver = {"n_nonzero_coefs": OMP_T}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("X.npy", "W.npy", "Z.npy")]
        np.save(paths[0], xc)
        np.save(paths[1], W_np)
        argv = sys.argv
        sys.argv = ["lasso_tpu_torch", "encode", paths[0], paths[1], "-o",
                    paths[2], "--algorithm", "omp", "--chunk-size",
                    str(CLI_CHUNK), "--solver-args", json.dumps(solver)]
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        runpy.run_module("lasso_tpu_torch", run_name="__main__",
                         alter_sys=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cli_counts = _cuda.launch_counts()
        sys.argv = argv
        zc = np.load(paths[2])
    print(f"[11] CLI encode --algorithm omp, {CLI_ROWS} rows in chunks of "
          f"{CLI_CHUNK}: {seconds:.3f} s, launch counts "
          f"{json.dumps(cli_counts)}")
    chunks = -(-CLI_ROWS // CLI_CHUNK)
    for key, v in {"fused_omp_solve": chunks, "omp_select_f32": chunks * OMP_T,
                   "omp_orth": chunks * OMP_T,
                   "omp_backsub": chunks}.items():
        check(cli_counts.get(key, 0) == v,
              f"CLI {key}: {cli_counts.get(key, 0)} != {v}")
    for lo, hi in ((0, CLI_CHUNK), (2 * CLI_CHUNK, CLI_ROWS)):
        xd = torch.from_numpy(xc[lo:hi]).to(DEV)
        direct = sparse_encode(xd, W, **kw)
        ok, share, err, rel, _ = omp_equivalent(
            xd, W, direct, torch.from_numpy(zc[lo:hi]).to(DEV))
        print(f"[11] CLI rows {lo}:{hi} against a direct sparse_encode: "
              f"supports equal on {share:.4f} of rows, codes max|err| "
              f"{err:.3e}")
        check(ok, f"omp CLI rows {lo}:{hi}")
    check(zc.shape == (CLI_ROWS, K) and np.isfinite(zc).all()
          and int((zc != 0).sum(axis=1).max()) <= OMP_T, "omp CLI codes")
    return counts


def spd_systems(B_, D_, seed):
    """b [B_, D_] and A = Q Q^T + 2 I [B_, D_, D_] on the card, Q standard
    normal (tests/test_linalg.py:140-159)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    Q = torch.randn(B_, D_, D_, generator=g, device=DEV)
    A = Q @ Q.transpose(1, 2) + 2 * torch.eye(D_, device=DEV)
    return torch.randn(B_, D_, generator=g, device=DEV), A


def chol_solve_bound_ms(B_, D_):
    """The two terms of K8's bound in ms: the bytes the solve needs (A is
    symmetric, so one triangle of it, D (D + 1) / 2 floats a sample, and b
    read, x written) over the memory rate, and its B (D^3 / 3 + 2 D^2)
    operations over the FP32 peak."""
    t_bytes = 4 * B_ * (D_ * (D_ + 1) / 2 + 2 * D_) / HBM_BYTES_PER_S * 1e3
    t_ops = B_ * (D_ ** 3 / 3 + 2 * D_ ** 2) / PEAK_FLOPS["f32"] * 1e3
    return t_bytes, t_ops


def chol_solve_sector_ms(B_, D_):
    """The byte term of K8 as it reads A: row k from the diagonal on, each
    row's tail rounded out to whole 32-byte sectors, plus b and x."""
    sectors = 0
    for k in range(D_):
        lo, hi = 4 * (k * D_ + k), 4 * (k * D_ + D_)
        sectors += (hi - 1) // 32 - lo // 32 + 1
    return B_ * (32 * sectors + 8 * D_) / HBM_BYTES_PER_S * 1e3


def phase_chol_solve():
    """K8 (chol_solve) against its plain version on the card at every shape
    listed, the non-PD sample and the whole-batch LU fallback, then K8 alone
    at B=16384, D=64 (the 'chol-full' solve's shape): time, plain time,
    library time, bound."""
    errs = {}
    for B_, D_ in ((N, OMP_T), (1024, 256), (130, 12), (130, 16),
                   (130, 33), (130, 65), (130, 100), (1, OMP_T), (1, 256)):
        b, A = spd_systems(B_, D_, seed=B_ + D_)
        x = B.batch_cholesky_solve_lanes(b, A)
        torch.cuda.synchronize()
        want = B.batch_cholesky_solve_lanes_plain(b, A)
        errs[(B_, D_)] = float((x - want).abs().max())
        worst = rel_excess(x, want, 1e-4)
        print(f"[12] chol_solve B={B_} D={D_}: max|err| {errs[(B_, D_)]:.3e}, "
              f"max(|err| - 1e-4 |plain|) {worst:.3e} (atol 1e-5), finite "
              f"{bool(torch.isfinite(x).all())}")
        check(worst <= 1e-5 and bool(torch.isfinite(x).all()),
              f"chol_solve B={B_} D={D_}")
        del b, A, x, want
    # one sample that is not PD: a non-finite x from the kernel, the others
    # finite; batch_cholesky_solve then takes LU for the whole batch
    b, A = spd_systems(N, OMP_T, seed=12)
    A[5] = -torch.eye(OMP_T, device=DEV)
    x = B.batch_cholesky_solve_lanes(b, A)
    others = torch.ones(N, dtype=torch.bool, device=DEV)
    others[5] = False
    bad_ok = (not bool(torch.isfinite(x[5]).any())
              and bool(torch.isfinite(x[others]).all()))
    lu_before = _cuda.launch_counts().get("batch_cholesky_solve_lu", 0)
    got = basic.batch_cholesky_solve(b, A)
    lu_calls = (_cuda.launch_counts().get("batch_cholesky_solve_lu", 0)
                - lu_before)
    ref = torch.linalg.solve(A.double(), b.double()[:, :, None])[:, :, 0]
    e_lu = float((got.double() - ref).abs().max())
    print(f"[12] non-PD sample 5 of {N}: kernel x non-finite there and finite "
          f"elsewhere {bad_ok}; batch_cholesky_solve took LU {lu_calls} time, "
          f"max|err| against a float64 solve {e_lu:.3e} (atol 1e-4)")
    check(bad_ok and lu_calls == 1 and e_lu <= 1e-4,
          "chol_solve non-PD sample and the LU fallback")
    del b, A, x, got, ref

    # K8 alone at B = N, D = T
    b, A = spd_systems(N, OMP_T, seed=13)
    t_bytes, t_ops = chol_solve_bound_ms(N, OMP_T)

    # torch.cholesky_solve runs MAGMA's spotrs_batched here, which cannot be
    # captured in a CUDA graph, and events around eager calls time the host
    # too: the library's card time is the sum of its operations' device times
    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[:, :, None], L)

    e_lib = float((library()[:, :, 0] - B.batch_cholesky_solve_lanes(b, A))
                  .abs().max())
    row = {"name": "chol_solve", "shape": f"B={N}, D={OMP_T}",
           "route": "cuda", "source": CHOL_SOURCE,
           "replaces": CHOL_SOLVE_REPLACES, "launches": None,
           "max_abs_err": errs[(N, OMP_T)],
           "ms": cuda_ms(lambda: B.batch_cholesky_solve_lanes(b, A)),
           "plain_ms": graph_ms(
               lambda: B.batch_cholesky_solve_lanes_plain(b, A)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": 1e3 * sum(kernel_seconds(library)
                                   for _ in range(5)) / 5}
    b2, A2 = spd_systems(1024, 256, seed=14)
    ms_256 = cuda_ms(lambda: B.batch_cholesky_solve_lanes(b2, A2))
    bound_256 = max(chol_solve_bound_ms(1024, 256))
    lib_eager = cuda_ms(library)
    print(f"[12] {json.dumps(row)} (B={N}, D={OMP_T}; ms: mean of 20 "
          f"launches; plain_ms: CUDA-graph replays; library: "
          f"torch.linalg.cholesky_ex + torch.cholesky_solve, timed only, "
          f"{e_lib:.3e} from the kernel; library_ms: the card time of its "
          f"operations by torch.profiler, mean of 5 calls, by name "
          f"{json.dumps(kernel_ms_by_name(library))}, against "
          f"{lib_eager:.4f} ms a call by events around 20 calls from Python; "
          f"bound: one triangle of A, b and x, "
          f"{t_bytes:.4f} ms, {chol_solve_sector_ms(N, OMP_T):.4f} ms with "
          f"A's row tails rounded to 32-byte sectors; max_abs_err at the "
          f"other shapes: "
          + ", ".join(f"B={k[0]} D={k[1]} {v:.3e}" for k, v in errs.items())
          + f"); at B=1024, D=256: {ms_256:.4f} ms, bound {bound_256:.4f} ms")
    return row


def phase_chol_full(x_np, W_np):
    """OMP 'chol-full' at the OMP width through sparse_encode (the main run
    of this slice, launches counted: K8 once a step, no LU fallback),
    against the fused solve; its share of a step; a tol run; the explicit
    'chol' with use_pallas=False at a small shape; OMP dictionary learning
    at the training width."""
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    kw = dict(algorithm="omp", n_nonzero_coefs=OMP_T)
    z_fused = sparse_encode(x, W, **kw)
    rss_fused = omp_rss64(x, W, z_fused)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    z, n_iter = sparse_encode(x, W, solver="chol-full", return_iters=True,
                              **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _cuda.launch_counts()
    nnz = (z != 0).sum(dim=1)
    print(f"[13] omp chol-full: {1 / seconds:.3f} solves/s ({seconds:.4f} s, "
          f"{seconds / OMP_T * 1e3:.3f} ms a step), n_iter {n_iter}, mean rss "
          f"{float(omp_rss64(x, W, z).mean()):.6f}, nnz per row "
          f"{int(nnz.min())}-{int(nnz.max())}, launches {json.dumps(counts)}")
    check(int(nnz.max()) <= OMP_T and bool(torch.isfinite(z).all())
          and tuple(z.shape) == (N, K) and n_iter == OMP_T,
          "omp chol-full: codes")
    check(counts.get("chol_solve", 0) == OMP_T
          and counts.get("batch_cholesky_solve_lu", 0) == 0,
          f"omp chol-full: {counts.get('chol_solve', 0)} chol_solve launches "
          f"(want {OMP_T}), {counts.get('batch_cholesky_solve_lu', 0)} LU "
          f"fallbacks (want 0)")
    print("[13] fused against chol-full:")
    check(omp_agree_at_scale(x, W, z, z_fused, 13),
          "fused and chol-full agree at the headline")
    by_name = kernel_ms_by_name(lambda: sparse_encode(
        x, W, solver="chol-full", **kw))
    k8 = sum(v for k, v in by_name.items() if "chol_solve" in k)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"[13] chol-full kernel time by name over one solve (ms): "
          f"{json.dumps(dict(top))}; K8 {k8:.3f} ms = {k8 / OMP_T:.4f} ms a "
          f"step, {100 * k8 / total:.1f}% of {total:.3f} ms of kernels")

    # a tol that about half of the rows reach before T steps
    tol = float(torch.quantile(rss_fused.float(), 0.5)) * 1.05
    before = _cuda.launch_counts()
    zt, it = sparse_encode(x, W, solver="chol-full", tol=tol,
                           return_iters=True, **kw)
    torch.cuda.synchronize()
    k8_tol = _cuda.launch_counts()["chol_solve"] - before["chol_solve"]
    frozen = (zt != 0).sum(dim=1) < OMP_T
    over = float((omp_rss64(x, W, zt)[frozen] / tol).max())
    print(f"[13] chol-full tol {tol:.6g}: {int(frozen.sum())} of {N} rows "
          f"froze before {OMP_T} atoms, their rss at most {over:.6f} x tol, "
          f"n_iter {it}, {k8_tol} chol_solve launches")
    check(0 < int(frozen.sum()) < N and over <= 1 + 1e-3 and it == OMP_T
          and k8_tol == it, "omp chol-full tol freeze")
    del z, zt, z_fused

    # an explicit 'chol' without the append route warns and takes the
    # exact 'chol-full' (the library's factorization with use_pallas=False)
    xs, Ws = omp_case(1000, 256, 512, 13, seed=130)
    before = _cuda.launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zc = sparse_encode(xs, Ws, algorithm="omp", n_nonzero_coefs=13,
                           solver="chol", use_pallas=False)
    k8_lib = _cuda.launch_counts()["chol_solve"] - before["chol_solve"]
    zf = sparse_encode(xs, Ws, algorithm="omp", n_nonzero_coefs=13,
                       solver="chol-full", use_pallas=False)
    warned = any("chol-full" in str(w.message) for w in caught)
    same = bool(torch.equal(zc, zf))
    print(f"[13] solver='chol', use_pallas=False at 1000x256->512, T=13: "
          f"warned {warned}, codes equal to 'chol-full' {same}, "
          f"{k8_lib} chol_solve launches (the library route)")
    check(warned and same and k8_lib == 0,
          "explicit chol off the append route")

    # OMP dictionary learning at the training width: 3 EM steps, T=16
    X = torch.from_numpy(training_data()).to(DEV)
    t0 = time.perf_counter()
    Wd, losses = DL.dict_learning(X, TRAIN_K, alpha=0.0, constrained=True,
                                  steps=3, algorithm="omp",
                                  n_nonzero_coefs=16)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ls = losses.cpu().numpy()
    rising = float(np.max(np.diff(ls)))
    print(f"[13] OMP dict_learning {TRAIN_N}x{TRAIN_D}->{TRAIN_K}, T=16, 3 "
          f"steps: {seconds:.3f} s, losses {ls.tolist()}, largest rise "
          f"{rising:.3e} (at most 1e-5 of the first loss)")
    check(np.isfinite(ls).all() and rising <= 1e-5 * ls[0]
          and bool(torch.isfinite(Wd).all()), "OMP dict_learning losses")
    return counts


def conv_geometry(cfg):
    """(N, Cz, Cx, Hz, k) of a conv configuration over 32x32 images."""
    n, cz, cx, k = CONV_CONFIGS[cfg]
    return n, cz, cx, 33 - k, k


def conv_operands(n, cz, cx, hz, wz, kh, kw, pad, seed):
    """x, W, z, z_prev on the card for one conv step (W / kh as the
    benchmark draws it, codes of size 0.1)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = torch.randn(n, cx, hz + kh - 1 - 2 * pad, wz + kw - 1 - 2 * pad,
                    generator=g, device=DEV)
    W = torch.randn(cz, cx, kh, kw, generator=g, device=DEV) / kh
    z = 0.1 * torch.randn(n, cz, hz, wz, generator=g, device=DEV)
    zp = z + 0.05 * torch.randn(n, cz, hz, wz, generator=g, device=DEV)
    return x, W, z, zp


def conv_step_size(W, imsize, pad):
    """0.9 / L, L the top eigenvalue of the conv normal operator by power
    iteration: a step that the solvers would take (a larger one lets the
    iterates grow, and with them the kernels' rounding differences)."""
    return 0.9 / float(lip_constant(W, tuple(imsize), padding=pad,
                                    maxiter=100))


def conv_bound_ms(n, cz, cx, hz, wz, kh, kw, pad, kp):
    """The bounds of K9a and K9b in ms: (bytes term, operations term)
    each. Operations: 2 per multiply-add of the taps that land inside the
    image (the same pairs for the conv and its adjoint), on the tensor
    cores at the bf16 rate, three times over in 'f32' (its bf16x3 split,
    the least time for this f32-grade work); bytes: K9a reads z, z_prev
    and x and writes r, K9b reads r, z and z_prev and writes z+."""
    H, W_ = hz + kh - 1 - 2 * pad, wz + kw - 1 - 2 * pad
    rows = sum(1 for i in range(H) for a in range(hz)
               if 0 <= i + pad - a < kh)
    cols = sum(1 for j in range(W_) for b in range(wz)
               if 0 <= j + pad - b < kw)
    t_ops = (2 * n * cz * cx * rows * cols * (3 if kp == "f32" else 1)
             / PEAK_FLOPS["bf16"] * 1e3)
    zb, xb = 4 * n * cz * hz * wz, 4 * n * cx * H * W_
    return ((2 * zb + 2 * xb) / HBM_BYTES_PER_S * 1e3, t_ops), \
        ((xb + 3 * zb) / HBM_BYTES_PER_S * 1e3, t_ops)


def phase_conv_kernels():
    """K9a and K9b (csrc/conv.cu) against their plain versions on the card:
    three sub-steps of fused_conv_fista_multistep at every listed shape in
    f32 and bf16; then each kernel alone at the headline and rich shapes,
    timed beside its plain version, cuDNN and its bound. Returns the rows
    of the headline shape and those of the rich one."""
    cases = [  # (label, n, cz, cx, hz, wz, kh, kw, pad, options)
        ("ragged 4x2 pad 1 nonneg", 3, 8, 2, 7, 9, 4, 2, 1,
         {"nonneg": True}),
        ("kw 9 pad 1", 3, 8, 1, 5, 5, 3, 9, 1, {}),
        ("kw 11", 3, 8, 1, 6, 8, 11, 11, 0, {}),
        ("per-channel threshold", 3, 8, 1, 7, 7, 3, 3, 0, {"percol": True}),
        ("restart", 4, 8, 1, 9, 9, 3, 3, 0, {"restart": True}),
        ("restart, per-channel, 40x37 codes pad 2", 3, 13, 5, 40, 37, 5, 5,
         2, {"restart": True, "percol": True}),
        ("headline", 256, 64, 1, 26, 26, 7, 7, 0, {}),
        ("rich", 64, 256, 16, 28, 28, 5, 5, 0, {}),
    ]
    moms = torch.tensor([0.3, 0.15, 0.0])
    errs = {}
    for label, n, cz, cx, hz, wz, kh, kw, pad, opt in cases:
        x, W, z, zp = conv_operands(n, cz, cx, hz, wz, kh, kw, pad, seed=n)
        lr = conv_step_size(W, x.shape[2:], pad)
        g = torch.Generator(device=DEV).manual_seed(cz)
        ths = (lr * (0.05 + 0.25 * torch.rand(cz, 1, generator=g,
                                              device=DEV))
               if opt.get("percol") else CONV_ALPHA * lr)
        for kp in ("f32", "bf16"):
            t0 = (3 * torch.rand(n, generator=g, device=DEV)
                  if opt.get("restart") else None)
            args = (x, z, zp, W, lr, ths, moms, 3)
            kw_ = dict(padding=pad, kernel_precision=kp,
                       nonneg=opt.get("nonneg", False), t_vec=t0)
            got = FC.fused_conv_fista_multistep(*args, **kw_)
            torch.cuda.synchronize()
            want = FC.fused_conv_fista_multistep_plain(*args, **kw_)
            scale = max(1.0, float(want[0].abs().max()))
            e_z = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
            e_d = abs(float(got[-1]) - float(want[-1])) / max(
                1e-30, abs(float(want[-1])))
            t_same = t0 is None or bool(torch.equal(got[2], want[2]))
            errs[(label, kp)] = e_z
            print(f"[14] {label} {n}x{cx}->{cz} {kh}x{kw} pad {pad} {kp}: "
                  f"max|z err| {e_z:.3e} (atol {CONV_TOL[kp][0]} x "
                  f"{scale:.3g}), delta rel err {e_d:.3e} (tol "
                  f"{CONV_TOL[kp][1]}), restart t equal {t_same}")
            check(e_z <= CONV_TOL[kp][0] * scale and e_d <= CONV_TOL[kp][1]
                  and t_same, f"K9a/K9b {label} {kp} against plain")
        del x, W, z, zp

    rows, rich_rows = {}, {}
    NF = torch.nn.functional
    for cfg in ("headline", "rich"):
        n, cz, cx, hz, k = conv_geometry(cfg)
        x, W, z, zp = conv_operands(n, cz, cx, hz, hz, k, k, 0, seed=14)
        lr = conv_step_size(W, x.shape[2:], 0)
        scal = torch.tensor([lr, CONV_ALPHA * lr, 0.3, 1.0], device=DEV)
        r_out, z_out = torch.empty_like(x), torch.empty_like(z)
        scratch = FC.adjoint_scratch(n, cz, hz, hz, DEV)
        bounds = conv_bound_ms(n, cz, cx, hz, hz, k, k, 0, "f32")
        for kp in ("f32", "bf16"):
            ops = FC.conv_operands(W, kp)   # W's parts, once a call
            r = FC.conv_decode_resid(x, z, zp, W, scal, kernel_precision=kp,
                                     operands=ops)
            torch.cuda.synchronize()
            e_a = float((r - FC.conv_decode_resid_plain(
                x, z, zp, W, scal, kernel_precision=kp)).abs().max())
            zn, _ = FC.conv_adjoint_prox(r, z, zp, W, scal,
                                         kernel_precision=kp)
            torch.cuda.synchronize()
            e_b = float((zn - FC.conv_adjoint_prox_plain(
                r, z, zp, W, scal, kernel_precision=kp)[0]).abs().max())
            check(e_a <= 1e-4 * max(1.0, float(r.abs().max()))
                  and e_b <= CONV_TOL[kp][0],
                  f"K9a/K9b alone at the {cfg} shape, {kp}")
            lib = torch.bfloat16 if kp == "bf16" else torch.float32
            zl, rl, Wl = z.to(lib), r.to(lib), W.to(lib)
            bnd = conv_bound_ms(n, cz, cx, hz, hz, k, k, 0, kp)
            for name, err, (t_bytes, t_ops), kern, plain, library in (
                    (f"conv_decode_resid_{kp}", e_a, bnd[0],
                     lambda: FC.conv_decode_resid(
                         x, z, zp, W, scal, kernel_precision=kp, out=r_out,
                         operands=ops),
                     lambda: FC.conv_decode_resid_plain(
                         x, z, zp, W, scal, kernel_precision=kp),
                     lambda: NF.conv_transpose2d(zl, Wl)),
                    (f"conv_adjoint_prox_{kp}", e_b, bnd[1],
                     lambda: FC.conv_adjoint_prox(
                         r, z, zp, W, scal, kernel_precision=kp, out=z_out,
                         scratch=scratch, operands=ops),
                     lambda: FC.conv_adjoint_prox_plain(
                         r, z, zp, W, scal, kernel_precision=kp),
                     lambda: NF.conv2d(rl, Wl))):
                row = {"name": name, "route": "cuda", "source": CONV_SOURCE,
                       "replaces": CONV_REPLACES, "launches": None,
                       "max_abs_err": err, "ms": cuda_ms(kern),
                       "plain_ms": graph_ms(plain, reps=10),
                       "bound_ms": max(t_bytes, t_ops),
                       "bound_by": ("bytes" if t_bytes >= t_ops
                                    else "operations"),
                       "library_ms": graph_ms(library, reps=10)}
                if cfg == "headline":
                    rows[name] = row
                else:
                    rich_rows[name] = {
                        "name": name,
                        "shape": f"{n}x{cx}x32x32, {cz} atoms {k}x{k}",
                        **{key: v for key, v in row.items()
                           if key != "name"}}
                print(f"[14] {cfg} {n}x{cx}->{cz} {k}x{k}: {json.dumps(row)} "
                      f"(bytes {t_bytes:.4f} ms, operations {t_ops:.4f} ms)")
        step_lib = graph_ms(lambda: NF.conv2d(NF.conv_transpose2d(z, W) - x,
                                              W), reps=10)
        print(f"[14] {cfg}: one step by cuDNN (conv_transpose2d, the "
              f"residual, conv2d; TF32 off, CUDA-graph replays) "
              f"{step_lib:.4f} ms; the step's bound in f32 "
              f"{max(bounds[0][0] + bounds[1][0], 2 * bounds[0][1]):.4f} "
              f"ms")
        del x, W, z, zp, r_out, z_out, scratch
    return rows, rich_rows


def conv_problem(cfg, reps):
    """``reps`` image batches and the atoms of a configuration, drawn as
    benchmarks/conv_fused_bench.py draws them (default_rng(0); W / k)."""
    n, cz, cx, _, k = conv_geometry(cfg)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((n, cx, 32, 32)).astype(np.float32)
          for _ in range(reps)]
    W = (rng.standard_normal((cz, cx, k, k)) / k).astype(np.float32)
    return xs, W


def conv_objective64(x, W, z):
    """The conv lasso objective in float64 on the card."""
    xh = torch.nn.functional.conv_transpose2d(z.double(), W.double())
    return float(0.5 * torch.sum((xh - x.double()) ** 2)
                 + CONV_ALPHA * torch.sum(z.double().abs()))


def conv_launches(before):
    """K9a and K9b launches (both precisions) since ``before``."""
    now = _cuda.launch_counts()
    return [sum(now.get(f"{k}_{kp}", 0) - before.get(f"{k}_{kp}", 0)
                for kp in ("f32", "bf16"))
            for k in ("conv_decode_resid", "conv_adjoint_prox")]


def timed_conv(x, z0, W, lr, **kw):
    """One ista_conv2d solve between two synchronizes, with a readback:
    (codes, n_iter, seconds, [K9a, K9b] launches)."""
    torch.cuda.synchronize()
    before = _cuda.launch_counts()
    t0 = time.perf_counter()
    z, k = ista_conv2d(x, z0, W, CONV_ALPHA, lr=lr, return_iters=True, **kw)
    float(z[0, 0, 0, 0])
    seconds = time.perf_counter() - t0
    return z, k, seconds, conv_launches(before)


def phase_conv_slice():
    """Conv sparse coding through ista_conv2d at the reference's width (the
    main run of this slice, counts read around the four headline solves),
    the rich width, a tol run and chunked serving."""
    xs_np, W_np = conv_problem("headline", 4)
    xs = [torch.from_numpy(a).to(DEV) for a in xs_np]
    W = torch.from_numpy(W_np).to(DEV)
    n, cz, _, hz, _ = conv_geometry("headline")
    z0 = torch.zeros(n, cz, hz, hz, device=DEV)
    lr = float(1.0 / lip_bound_conv2d(W, 0))
    base = dict(maxiter=CONV_ITERS, tol=0.0)
    variants = {"f32": {}, "bf16": {"kernel_precision": "bf16"},
                "mixed": {"kernel_precision": "mixed"},
                "f32 restart": {"restart": True}}
    for kw in variants.values():   # warm-up on the first input
        timed_conv(xs[0], z0, W, lr, **base, **kw)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    f64, codes, walls = {}, {}, {}
    for label, kw in variants.items():
        times = []
        for x in xs[1:]:
            z, k, seconds, (na, nb) = timed_conv(x, z0, W, lr, **base, **kw)
            check(k == CONV_ITERS and na == nb == CONV_ITERS,
                  f"conv {label}: n_iter {k}, {na} K9a and {nb} K9b "
                  f"launches (want {CONV_ITERS} each)")
            times.append(seconds)
        codes[label], walls[label] = z, min(times)
        f64[label] = conv_objective64(xs[-1], W, z)
        check(bool(torch.isfinite(z).all()) and tuple(z.shape) == tuple(
            z0.shape), f"conv {label}: codes finite, of the codes' shape")
        print(f"[15] conv headline {label}: {CONV_ITERS / min(times):.2f} "
              f"iterations/s (min of {len(times)} inputs; seconds "
              f"{[round(s, 4) for s in times]}), f64 objective "
              f"{f64[label]:.10g}, sparsity "
              f"{float((z == 0).float().mean()):.4f}")
    counts = _cuda.launch_counts()
    print("[15] conv headline launch counts:", json.dumps(counts))
    # the kernel / host split of a solve: the card's kernel time of one
    # (torch.profiler) against its wall time above
    for label in ("f32", "bf16"):
        by_name = kernel_ms_by_name(
            lambda: timed_conv(xs[-1], z0, W, lr, **base, **variants[label]))
        conv_ms = sum(v for k, v in by_name.items() if "conv_" in k)
        busy = sum(by_name.values())
        wall = 1e3 * walls[label]
        print(f"[15] conv headline {label} split: {wall:.3f} ms a solve, "
              f"kernels {busy:.3f} ms ({100 * busy / wall:.1f}%; K9a + K9b "
              f"{conv_ms:.3f} ms), the rest host or idle "
              f"{wall - busy:.3f} ms")

    x = xs[-1]
    z_u, k_u, s_u, launched = timed_conv(x, z0, W, lr, use_pallas=False,
                                         **base)
    f_u = conv_objective64(x, W, z_u)
    rel = abs(f64["f32"] - f_u) / f_u
    print(f"[15] unfused f32 (cuDNN, TF32 off): {CONV_ITERS / s_u:.2f} "
          f"iterations/s, f64 objective {f_u:.10g}; fused f32 relative "
          f"{rel:.3e} (tol 1e-5), max|z - z_unfused| "
          f"{float((codes['f32'] - z_u).abs().max()):.3e}")
    check(rel <= 1e-5 and launched == [0, 0],
          "conv headline: fused f32 against the unfused route")
    z_a, _, _, _ = timed_conv(x, z0, W, lr, maxiter=8 * CONV_ITERS, tol=0.0)
    f_a = conv_objective64(x, W, z_a)
    for label in ("mixed", "bf16"):
        gap = 100.0 * (f64[label] - f64["f32"]) / max(f64["f32"] - f_a,
                                                      1e-30)
        print(f"[15] conv headline gap_vs_f32_pct {label}: {gap:.4f} "
              f"({8 * CONV_ITERS}-iteration f32 anchor {f_a:.10g})")
        check(np.isfinite(gap), f"conv {label} gap finite")
    check(f_a <= f64["f32"], "conv anchor below the f32 solve")

    # tol runs: the fused route stops on a block boundary (S = 10, the
    # largest divisor of 200 that is at most 16), never earlier than the
    # unfused route. At 1e-5 the objectives agree to 1e-5; at 1e-4, where
    # both stop early, a step still moves the objective by more than that,
    # so only the counts are held there.
    S = 10
    for tol in (1e-5, 1e-4):
        z_f, k_f, _, _ = timed_conv(x, z0, W, lr, maxiter=CONV_ITERS,
                                    tol=tol)
        z_t, k_t, _, _ = timed_conv(x, z0, W, lr, maxiter=CONV_ITERS,
                                    tol=tol, use_pallas=False)
        f_f, f_t = conv_objective64(x, W, z_f), conv_objective64(x, W, z_t)
        print(f"[15] conv tol {tol:g}: fused n_iter {k_f}, unfused n_iter "
              f"{k_t}, f64 objectives {f_f:.10g} / {f_t:.10g} (relative "
              f"{abs(f_f - f_t) / f_t:.3e})")
        check((k_f % S == 0 or k_f == CONV_ITERS) and k_f >= k_t
              and (tol > 1e-5 or abs(f_f - f_t) <= 1e-5 * f_t),
              f"conv tol {tol:g} run")

    # the rich width
    xr_np, Wr_np = conv_problem("rich", 3)
    xr = [torch.from_numpy(a).to(DEV) for a in xr_np]
    Wr = torch.from_numpy(Wr_np).to(DEV)
    n, cz, _, hz, _ = conv_geometry("rich")
    zr0 = torch.zeros(n, cz, hz, hz, device=DEV)
    lr_r = float(1.0 / lip_bound_conv2d(Wr, 0))
    f_r = {}
    for label, kw in (("f32", {}), ("mixed", {"kernel_precision": "mixed"}),
                      ("unfused f32", {"use_pallas": False})):
        times = []
        for xi in xr:
            z, k, seconds, (na, nb) = timed_conv(xi, zr0, Wr, lr_r, **base,
                                                 **kw)
            want = 0 if label == "unfused f32" else CONV_ITERS
            check(k == CONV_ITERS and na == nb == want,
                  f"conv rich {label}: n_iter {k}, launches {na}, {nb}")
            times.append(seconds)
        f_r[label] = conv_objective64(xr[-1], Wr, z)
        print(f"[15] conv rich {label}: {CONV_ITERS / min(times[1:]):.2f} "
              f"iterations/s (min of {len(times) - 1} inputs after one), f64 "
              f"objective {f_r[label]:.10g}")
    rel = abs(f_r["f32"] - f_r["unfused f32"]) / f_r["unfused f32"]
    rel_mixed = (f_r["mixed"] - f_r["f32"]) / f_r["f32"]
    print(f"[15] conv rich: fused f32 relative to unfused {rel:.3e} (tol "
          f"1e-5); mixed relative {rel_mixed:.3e}")
    check(rel <= 1e-5, "conv rich: fused f32 against the unfused route")
    del xr, zr0

    # serving: 600 images in chunks of 256 (the last one 88, padded)
    rng = np.random.default_rng(15)
    xs_serve = rng.standard_normal((CONV_SERVE, 1, 32, 32)).astype(np.float32)
    t0 = time.perf_counter()
    served = chunked_encode(xs_serve, W, alpha=CONV_ALPHA,
                            chunk_size=CONV_CHUNK, algorithm="ista_conv2d",
                            lr=lr, **base)
    seconds = time.perf_counter() - t0
    worst = 0.0
    for start in range(0, CONV_SERVE, CONV_CHUNK):
        xb = torch.from_numpy(xs_serve[start:start + CONV_CHUNK]).to(DEV)
        zb = ista_conv2d(xb, torch.zeros((len(xb),) + tuple(z0.shape[1:]),
                                         device=DEV), W, CONV_ALPHA, lr=lr,
                         **base)
        worst = max(worst, float(np.abs(served[start:start + len(xb)]
                                        - zb.cpu().numpy()).max()))
    print(f"[15] chunked_encode(algorithm='ista_conv2d') {CONV_SERVE} images "
          f"in chunks of {CONV_CHUNK}: {seconds:.3f} s, codes "
          f"{served.shape}, max|err| against direct calls {worst:.3e} "
          f"(atol 1e-6)")
    check(served.shape == (CONV_SERVE,) + tuple(z0.shape[1:])
          and worst <= 1e-6, "chunked conv serving row for row")
    return counts



# phase 16: the rest of sparse_encode. The gap bound of each run is that of
# the solver's JAX test against a deep FISTA solve (objectives within
# rtol * max(1, |f*|)): tests/test_gpsr.py:28, test_iterative_ridge.py:28,
# test_heavy_solvers.py:36, :44, :54 (own: f < 1.1 f*) and :143 (the
# penalized constrained form)
SOLVER_GAP_BOUND = {"gpsr": 5e-3, "iter-ridge": 1e-2, "interior-point": 1e-2,
                    "split-bregman": 1e-2, "own": 1e-1, "constrained": 1e-3}
SOLVER_ANCHOR_ITERS = 3200       # the deep f32 FISTA solve of the port
# the headline width's budgets: each solver's defaults, but for three, the
# smallest that met the bound in scripts/solver_budgets.py (PERF.md):
# gpsr's LCP test (tol 1e-2, a max over the batch) never passed in 1000
# iterations (8.4 s), so it takes 500 (its gap 1.6e-2 at 200);
# interior-point takes 20 Newton steps of at most 128 CG iterations in
# place of 512 (16.8 s; its gap 1.9e-2 at 64); split-bregman's default 20
# outer iterations left a gap of 2.7e-2, so 'f32' takes 100 and 'mixed',
# whose bf16 phase leaves a floor that its f32 tail of maxiter // 8 must
# remove, 200 (1.8e-2 at 100)
SOLVER_RUNS = (
    ("gpsr", "gpsr", {"maxiter": 500}),
    ("iter-ridge", "iter-ridge", {}),
    ("interior-point", "interior-point", {"maxiter": 20, "cg_maxiter": 128}),
    ("split-bregman f32", "split-bregman", {"maxiter": 100}),
    ("split-bregman mixed", "split-bregman",
     {"maxiter": 200, "kernel_precision": "mixed"}),
    ("own", "own", {}),
)


def objective64_dev(x, W, z, alpha):
    """The lasso objective of codes z in float64 on the card."""
    r = z.double() @ W.double().T - x.double()
    return float(0.5 * torch.sum(r * r) + alpha * torch.sum(z.double().abs()))


def kkt_violation64(x, W, z, alpha, support_tol=1e-6):
    """The largest violation of the lasso's KKT conditions in float64
    (tests/_oracles.py:20-32): |g_k + alpha sign(z_k)| on the support,
    max(|g_k| - alpha, 0) off it, g = W^T (W z - x)."""
    z64 = z.double()
    g = (z64 @ W.double().T - x.double()) @ W.double()
    on = z64.abs() > support_tol
    v_on = torch.where(on, (g + alpha * torch.sign(z64)).abs(), 0.0)
    v_off = torch.where(on, 0.0, torch.clamp_min(g.abs() - alpha, 0.0))
    return float(torch.maximum(v_on.max(), v_off.max()))


def count_syncs(fn):
    """Run ``fn`` once under CUDA's sync debug mode and count the
    synchronizing CUDA calls it made. Returns (fn's result, the count)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def fista_anchor(x, W, alpha):
    """f64 objective of a deep f32 FISTA solve of the port (lr = 1/L,
    SOLVER_ANCHOR_ITERS iterations, tol 0, fused 'f32' path), the drift of
    half the iterations above it, and the codes."""
    lr = float(1.0 / lipschitz_constant(W))
    z = sparse_encode(x, W, alpha, algorithm="ista", lr=lr, tol=0.0,
                      maxiter=SOLVER_ANCHOR_ITERS, kernel_precision="f32")
    half = sparse_encode(x, W, alpha, algorithm="ista", lr=lr, tol=0.0,
                         maxiter=SOLVER_ANCHOR_ITERS // 2,
                         kernel_precision="f32")
    f, f_half = objective64_dev(x, W, z, alpha), objective64_dev(
        x, W, half, alpha)
    return f, (f_half - f) / abs(f), z


def timed_solve(call, profile=False, host_ops=False):
    """Run a solve twice. The first run, under CUDA's sync debug mode (and
    with ``profile`` inside torch.profiler, tracing the host's operations
    too only with ``host_ops``), counts its synchronizing calls (and its
    kernel time by name) and warms the solver's shapes; the second is
    timed between two synchronizes, with the launch counts and the inner
    loops' iterations (``INNER_ITERATIONS``: CG, backtracking) read around
    it."""
    torch.cuda.synchronize()
    INNER_ITERATIONS.clear()
    if profile:
        ((_, n_first), syncs), by_name = profiled(
            lambda: count_syncs(call), host_ops=host_ops)
    else:
        (_, n_first), syncs = count_syncs(call)
        by_name = None
    inner_first = dict(INNER_ITERATIONS)
    INNER_ITERATIONS.clear()
    torch.cuda.synchronize()
    before = _cuda.launch_counts()
    t0 = time.perf_counter()
    z, n_iter = call()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = _cuda.launch_counts()
    return types.SimpleNamespace(
        z=z, n_iter=n_iter, seconds=seconds, syncs=syncs, kernels=by_name,
        launches={k: v - before.get(k, 0) for k, v in after.items()
                  if v != before.get(k, 0)},
        inner=dict(INNER_ITERATIONS),
        same_as_first=(inner_first == dict(INNER_ITERATIONS)
                       and n_first == n_iter))


def solver_report(label, x, W, f_star, z0, bound, solve):
    """Print one solve of phase 16 and check it: finite codes of z0's
    shape, an objective at most z0's, the gap to the FISTA anchor f_star
    at most ``bound`` (relative to max(1, |f_star|)). A profiled solve
    also prints its kernel time by name, against the timed run's wall
    time."""
    z = solve.z
    f = objective64_dev(x, W, z, ALPHA)
    f0 = objective64_dev(x, W, z0, ALPHA)
    gap = (f - f_star) / max(1.0, abs(f_star))
    kkt = kkt_violation64(x, W, z, ALPHA)
    print(f"[16] {label}: {solve.seconds:.4f} s, n_iter {solve.n_iter}, "
          f"inner iterations {json.dumps(solve.inner)} (the same in the "
          f"first run: {solve.same_as_first}), {solve.syncs} synchronizing "
          f"calls a solve, objective f64 {f:.10g} (z0's {f0:.10g}), gap "
          f"to the FISTA anchor {gap:.3e} (bound {bound:g}), KKT violation "
          f"{kkt:.3e} (alpha {ALPHA}), sparsity "
          f"{float((z == 0).float().mean()):.4f}, launches "
          f"{json.dumps(solve.launches)}")
    if solve.kernels is not None:
        print(f"[16] {label}: {kernel_split(solve.kernels, solve.seconds)}")
    check(bool(torch.isfinite(z).all()) and tuple(z.shape) == tuple(z0.shape),
          f"{label}: codes finite and [N, K]")
    check(f <= f0, f"{label}: objective {f} above its z0's {f0}")
    check(gap <= bound, f"{label}: gap {gap:.3e} above {bound:g}")


def kernel_split(by_name, seconds):
    """A profiled run's kernel time, its share of a timed run's wall
    time, its cuBLAS products and elementwise kernels, and the largest
    kernels by name."""
    total = sum(by_name.values())
    elementwise = sum(v for k, v in by_name.items() if "elementwise" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"kernels {total:.2f} ms ({100 * total / 1e3 / seconds:.1f}% of "
            f"the wall time): cuBLAS products {gemm_ms(by_name):.2f} ms, "
            f"elementwise {elementwise:.2f} ms; largest "
            f"{json.dumps(dict(top))}")


def gemm_ms(by_name):
    """The kernel time of cuBLAS's matrix products in a profiled split
    (its own GEMM kernels and the CUTLASS SIMT ones it picks)."""
    return sum(v for k, v in by_name.items()
               if "gemm" in k.lower() or "cutlass" in k)


def phase_solvers(x_np, W_np):
    """The rest of sparse_encode (gpsr, iter-ridge, interior-point,
    split-bregman, own, constrained_inference, OMP 'cg') at the headline
    width, and iter-ridge and interior-point on their Cholesky routes at
    the training width, where each ridge or Newton step launches K8 once
    (the main run of this slice: counts set to 0 just before those two
    solves and read just after). Each solve runs twice
    (:func:`timed_solve`). Returns the launch counts of the main run and
    K8's row at the shape these routes give it."""
    one = torch.ones(4, device=DEV)
    torch.cuda.synchronize()
    reads = {name: count_syncs(fn)[1] for name, fn in (
        ("bool", lambda: bool(one.any())), ("float", lambda: float(
            one.sum())), ("nothing", lambda: one * 2))}
    print(f"[16] synchronizing calls counted for one host read: "
          f"{json.dumps(reads)}")
    check(reads["bool"] > 0 and reads["float"] > 0 and reads["nothing"] == 0,
          "the sync debug mode counts host reads")
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    t0 = time.perf_counter()
    f_star, drift, _ = fista_anchor(x, W, ALPHA)
    print(f"[16] FISTA anchor at {N}x{D}->{K}: objective f64 {f_star:.10g}, "
          f"{SOLVER_ANCHOR_ITERS // 2} iterations {drift:.3e} relative above "
          f"it ({time.perf_counter() - t0:.2f} s)")
    check(abs(drift) <= 1e-5, "the FISTA anchor has converged")

    for label, name, kw in SOLVER_RUNS:
        z0 = linear.initialize_code(x, W, ALPHA, SE._init_defaults[name])
        call = (lambda name=name, kw=kw: sparse_encode(
            x, W, ALPHA, algorithm=name, return_iters=True, **kw))
        solve = timed_solve(call, profile=name == "interior-point")
        solver_report(label, x, W, f_star, z0, SOLVER_GAP_BOUND[name], solve)
        if name == "interior-point":
            # each inner CG iteration makes two products [N, D] x [D, 2K]
            # and back; the Newton steps' own products are in the GEMM time
            # but not in these operations, so the rate is a floor
            cg_iters = solve.inner.get("normal_cg", 0)
            gemm = gemm_ms(solve.kernels)
            flops = cg_iters * 2 * 2 * N * D * 2 * K
            print(f"[16] interior-point 'cg': {cg_iters} inner CG "
                  f"iterations, {1e3 * solve.seconds / max(cg_iters, 1):.4f}"
                  f" ms of wall time and {gemm / max(cg_iters, 1):.4f} ms of "
                  f"cuBLAS products each (profiled run: {gemm:.2f} ms of "
                  f"products); the CG products at least "
                  f"{flops / (gemm / 1e3) / 1e12:.2f} TFLOP/s")
    solve = timed_solve(lambda: (linear.solvers.constrained_inference(
        x, W, constr=False, alpha=ALPHA), 200))
    solver_report("constrained_inference, penalized", x, W, f_star,
                  torch.zeros((N, K), device=DEV),
                  SOLVER_GAP_BOUND["constrained"], solve)
    # the constrained form, rss_lim 0.3 of the mean row's 0.5 ||x||^2
    # (tests/test_heavy_solvers.py:123-132 takes 0.3 of row 0's), with a
    # cut bisection: 10 steps of 50 FISTA iterations
    rss_lim = float(0.5 * torch.mean(torch.sum(x * x, 1))) * 0.3
    solve = timed_solve(
        lambda: (linear.solvers.constrained_inference(
            x, W, constr=True, rss_lim=rss_lim, fista_iters=50,
            bisect_iters=10), 10))
    zc = solve.z
    rss = 0.5 * torch.sum((zc @ W.T - x) ** 2, dim=1)
    print(f"[16] constrained_inference, rss_lim {rss_lim:.4f}, 10 bisection "
          f"steps of 50 FISTA iterations: {solve.seconds:.4f} s, "
          f"{solve.syncs} synchronizing calls, rss max "
          f"{float(rss.max()):.4f} (at most 1.05 rss_lim), rows binding at "
          f"0.8 rss_lim {int((rss >= 0.8 * rss_lim).sum())} of {N}")
    check(bool(torch.isfinite(zc).all())
          and bool(torch.all(rss <= rss_lim * 1.05))
          and bool(torch.any(rss >= 0.8 * rss_lim)),
          "constrained_inference meets rss_lim (tests/test_heavy_solvers.py"
          ":131-132)")
    del zc, solve

    print(f"[16] {time.perf_counter() - t0:.1f} s into the phase: the "
          f"headline solves done")

    # OMP 'cg' at T=64 against 'chol-full' by phases 10-11's rule
    xo, Wo = (torch.from_numpy(a).to(DEV) for a in omp_problem())
    kw = dict(algorithm="omp", n_nonzero_coefs=OMP_T)
    z_full = sparse_encode(xo, Wo, solver="chol-full", **kw)
    solve = timed_solve(lambda: sparse_encode(
        xo, Wo, solver="cg", return_iters=True, **kw))
    z_cg = solve.z
    nnz = (z_cg != 0).sum(dim=1)
    print(f"[16] omp cg, T={OMP_T}: {1 / solve.seconds:.3f} solves/s "
          f"({solve.seconds:.4f} s), n_iter {solve.n_iter}, inner "
          f"iterations {json.dumps(solve.inner)}, {solve.syncs} "
          f"synchronizing calls a solve, mean rss "
          f"{float(omp_rss64(xo, Wo, z_cg).mean()):.6f} (chol-full "
          f"{float(omp_rss64(xo, Wo, z_full).mean()):.6f}), nnz per row "
          f"{int(nnz.min())}-{int(nnz.max())}, launches "
          f"{json.dumps(solve.launches)}")
    check(bool(torch.isfinite(z_cg).all()) and int(nnz.max()) <= OMP_T
          and solve.n_iter == OMP_T and not solve.launches, "omp cg: codes")
    print("[16] chol-full against cg:")
    check(omp_agree_at_scale(xo, Wo, z_full, z_cg, 16),
          "omp cg and chol-full agree at the headline")
    del xo, Wo, z_full, z_cg, solve

    print(f"[16] {time.perf_counter() - t0:.1f} s into the phase: OMP 'cg' "
          f"done")

    # the training width on the Cholesky routes: K8 once a step
    xs, Ws = headline_bench.make_problem(TRAIN_N, TRAIN_D, TRAIN_K, seed=16)
    xt = torch.from_numpy(xs[0]).to(DEV)
    Wt = torch.from_numpy(Ws).to(DEV)
    ft_star, drift, _ = fista_anchor(xt, Wt, ALPHA)
    print(f"[16] FISTA anchor at {TRAIN_N}x{TRAIN_D}->{TRAIN_K}: objective "
          f"f64 {ft_star:.10g}, half its iterations {drift:.3e} above it")
    check(abs(drift) <= 1e-5, "the training-width anchor has converged")
    runs = (("iter-ridge woodbury cholesky", "iter-ridge",
             {"woodbury_solver": "cholesky"}),
            ("interior-point cholesky", "interior-point",
             {"kkt_solver": "cholesky", "maxiter": 20}))
    # traced with the host's operations: a trace of the card's activity
    # alone held about half of interior-point's kernels in one full run
    # (1274 of some 2660 ms, K8 110.7 of 231 ms), all of them in another
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    solves = [timed_solve(lambda name=name, kw=kw: sparse_encode(
        xt, Wt, ALPHA, algorithm=name, return_iters=True, **kw), profile=True,
        host_ops=True) for _, name, kw in runs]
    counts = _cuda.launch_counts()
    print("[16] training-width launch counts (two runs a solve):",
          json.dumps({k: v for k, v in counts.items() if v}))
    z0 = linear.initialize_code(xt, Wt, ALPHA, "ridge")
    for (label, name, _), solve in zip(runs, solves):
        solver_report(f"{label}, {TRAIN_N}x{TRAIN_D}->{TRAIN_K}", xt, Wt,
                      ft_star, z0, SOLVER_GAP_BOUND[name], solve)
        k8 = sum(v for k, v in solve.kernels.items() if "chol_solve" in k)
        print(f"[16] {label}: K8 {k8:.3f} ms of the profiled run's kernels")
        got = solve.launches
        check(got.get("chol_solve", 0) == solve.n_iter
              and got.get("batch_cholesky_solve_lu", 0) == 0,
              f"{label}: {got.get('chol_solve', 0)} chol_solve launches "
              f"(want {solve.n_iter}), {got.get('batch_cholesky_solve_lu', 0)}"
              f" LU fallbacks (want 0)")
    del xt, Wt, solves

    print(f"[16] {time.perf_counter() - t0:.1f} s into the phase: the "
          f"Cholesky routes done")

    # K8 at the shape these routes give it, held to its plain version (the
    # rule of phase 12) and timed beside it, the library and its bound
    b, A = spd_systems(TRAIN_N, TRAIN_D, seed=16)
    got = B.batch_cholesky_solve_lanes(b, A)
    torch.cuda.synchronize()
    want = B.batch_cholesky_solve_lanes_plain(b, A)
    worst = rel_excess(got, want, 1e-4)
    err = float((got - want).abs().max())
    print(f"[16] chol_solve B={TRAIN_N} D={TRAIN_D}: max|err| {err:.3e}, "
          f"max(|err| - 1e-4 |plain|) {worst:.3e} (atol 1e-5)")
    check(worst <= 1e-5 and bool(torch.isfinite(got).all()),
          f"chol_solve B={TRAIN_N} D={TRAIN_D}")
    del got, want

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[:, :, None], L)

    t_bytes, t_ops = chol_solve_bound_ms(TRAIN_N, TRAIN_D)
    row = {"name": "chol_solve", "shape": f"B={TRAIN_N}, D={TRAIN_D}",
           "route": "cuda", "source": CHOL_SOURCE,
           "replaces": CHOL_SOLVE_REPLACES, "launches": None,
           "max_abs_err": err,
           "ms": cuda_ms(lambda: B.batch_cholesky_solve_lanes(b, A),
                         reps=10),
           "plain_ms": cuda_ms(
               lambda: B.batch_cholesky_solve_lanes_plain(b, A), reps=1,
               warm=0),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": 1e3 * sum(kernel_seconds(library)
                                   for _ in range(3)) / 3}
    print(f"[16] {json.dumps(row)} (ms: mean of 10 launches; plain_ms: one "
          f"call after the one held to the kernel; library_ms: torch.linalg.cholesky_ex + "
          f"torch.cholesky_solve, the card time of its operations by "
          f"torch.profiler, mean of 3 calls, timed only)")
    return counts, row


# phase 17: conv dictionary learning at benchmarks/conv_dl_bench.py's
# settings, and implicit gradients at benchmarks/group_bench.py:90-103's
CONV_DL_STEPS, CONV_DL_ITERS = 5, 30
IMPLICIT_ITERS, IMPLICIT_CG = 200, 64
# The bounds of the implicit gradients against the same gradients with
# use_pallas=False, written in PERF.md before the first run on the card.
# At alpha 0.1 the linear supports come near D (491 of 512 a row on the
# CPU, 256 rows) and the group supports far past it, so H_SS is near
# singular and a 1e-5 change in the codes moves the gradient by 6-13%
# there (x and W together, the ridge-free run); a code entry on one side
# of support_eps in one route and not in the other changes its row's
# system. So the ridge-free run is held to these whole-gradient bounds
# (four times the CPU estimate), and a run with ridge 1.0 (conv: the same
# run) holds the rows whose supports agree to 1e-3 in x and the whole W
# gradient to 1e-2. Parting support entries: at most 1e-4 of the codes.
IMPLICIT_BOUND = {"linear": 0.3, "group": 0.5, "conv": 1e-2}
IMPLICIT_RIDGE = 1.0
AGREEING_BOUND, W_BOUND, PARTING_SHARE = 1e-3, 1e-2, 1e-4
# Written in PERF.md before the run that first read them: in the run with
# ridge 1.0 the x gradient of the samples whose supports part, as a whole,
# to 0.3 (a parting entry is one near support_eps, and with the ridge it
# moves its row's gradient by a few per cent); and in the ridge-free run
# every sample's codes to 1e-2 of their norm, so that a fault confined to
# a few rows, which would part their supports and leave the agreeing
# check, still fails.
PARTING_GRAD_BOUND, ROW_CODE_BOUND = 0.3, 1e-2
# the encoders' support threshold, passed to them and used to compare the
# two routes' supports
SUPPORT_EPS = 1e-7
# the kernels each encoder's forward launches once an iteration
IMPLICIT_KERNELS = {
    "linear": ("fista_resid_f32", "fista_grad_prox_f32"),
    "group": ("fista_resid_f32", "fista_grad_prox_f32", "group_prox_f32"),
    "conv": ("conv_decode_resid_f32", "conv_adjoint_prox_f32")}
# conv DL: timed windows of CONV_DL_STEPS EM steps on the same input, and
# repeats of one step's parts; medians and spreads printed
CONV_DL_WINDOWS, CONV_DL_PART_REPEATS = 5, 3


def conv_dl_run(X, cz, k, seed, **kw):
    """conv_dict_learning at phase 17's settings: (weight, losses)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    return conv_dict_learning(X, cz, k, alpha=CONV_ALPHA,
                              steps=CONV_DL_STEPS, constrained=True,
                              maxiter=CONV_DL_ITERS, tol=0.0, generator=g,
                              **kw)


def phase_conv_dl():
    """Conv dictionary learning at conv_dl_bench.py's two widths (the main
    run of this part, timed in CONV_DL_WINDOWS windows: counts set to 0
    just before each window and read just after), 'f32' and 'mixed' on
    distinct inputs after a warm-up run each, the losses and filters
    checked, and an unfused 'f32' run held to the fused one. Returns
    {config: {kernel symbol: launches}}."""
    launches = collections.defaultdict(collections.Counter)
    for cfg in ("rich", "headline"):
        n, cz, cx, hz, k = conv_geometry(cfg)
        rng = np.random.default_rng(17)
        xs = [torch.from_numpy(rng.standard_normal((n, cx, 32, 32)).astype(
            np.float32)).to(DEV) for _ in range(3)]
        fused = {}
        for label, kw, x in (("f32", {}, xs[1]),
                             ("mixed", {"kernel_precision": "mixed"}, xs[2])):
            # the warm-up run, under CUDA's sync debug mode
            _, syncs = count_syncs(lambda: conv_dl_run(xs[0], cz, k, 0, **kw))
            rates, windows = [], []
            for _ in range(CONV_DL_WINDOWS):
                torch.cuda.synchronize()
                INNER_ITERATIONS.clear()
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                W, losses = conv_dl_run(x, cz, k, 1, **kw)
                losses = losses.cpu()
                rates.append(CONV_DL_STEPS / (time.perf_counter() - t0))
                launches[cfg].update(_cuda.launch_counts())
                windows.append((conv_launches({}),
                                INNER_ITERATIONS["conjgrad"]))
            per_kernel, cg = windows[0]
            # one EM step by its parts, the E-step, then the M-step
            t_e, t_m = [], []
            for _ in range(CONV_DL_PART_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                Z = ista_conv2d(x, torch.zeros(n, cz, hz, hz, device=DEV), W,
                                CONV_ALPHA, maxiter=CONV_DL_ITERS, tol=0.0,
                                **kw)
                torch.cuda.synchronize()
                t_e.append(time.perf_counter() - t0)
                update_kernel_constrained(x, Z, W, generator=torch.Generator(
                    device=DEV).manual_seed(2))
                torch.cuda.synchronize()
                t_m.append(time.perf_counter() - t0 - t_e[-1])
            norms = torch.linalg.vector_norm(W.reshape(cz, -1), dim=1)
            ls = losses.numpy().astype(np.float64)
            monotone = bool(np.all(np.diff(ls) <= 1e-6 * ls[:-1]))
            print(f"[17] conv_dict_learning {cfg} {n}x{cx}x32x32, {cz} "
                  f"filters {k}x{k}, {label}: median "
                  f"{float(np.median(rates)):.3f} EM steps/s over "
                  f"{CONV_DL_WINDOWS} windows of {CONV_DL_STEPS} steps (min "
                  f"{min(rates):.3f}, max {max(rates):.3f}: "
                  f"{[round(r, 3) for r in rates]}); one step's E-step "
                  f"median {float(np.median(t_e)):.4f} s, M-step "
                  f"{float(np.median(t_m)):.4f} s (of {CONV_DL_PART_REPEATS}: "
                  f"{[round(v, 4) for v in t_e]}, "
                  f"{[round(v, 4) for v in t_m]}); CG iterations an M-step "
                  f"{cg / CONV_DL_STEPS:g}; host syncs an EM step "
                  f"{syncs / CONV_DL_STEPS:g} (sync debug mode, the warm-up "
                  f"run); K9a, K9b launches a window {per_kernel}; losses "
                  f"{[float(v) for v in ls]} (monotone {monotone}); max "
                  f"||filter|| - 1 {float((norms - 1).abs().max()):.3e}")
            want = CONV_DL_STEPS * CONV_DL_ITERS
            check(all(w[0] == [want, want] for w in windows),
                  f"conv DL {cfg} {label}: K9a/K9b launches "
                  f"{[w[0] for w in windows]}, want {want} each a window")
            check(bool(np.isfinite(ls).all()) and monotone,
                  f"conv DL {cfg} {label}: losses finite and non-increasing")
            check(float((norms - 1).abs().max()) <= 1e-4,
                  f"conv DL {cfg} {label}: unit filters")
            fused[label] = (W, ls)
        # the unfused route (cuDNN, TF32 off) on the f32 run's input
        before = _cuda.launch_counts()
        W_u, losses_u = conv_dl_run(xs[1], cz, k, 1, use_pallas=False)
        ls_u = losses_u.cpu().numpy().astype(np.float64)
        W_f, ls_f = fused["f32"]
        rel = np.abs(ls_f - ls_u) / np.abs(ls_u)
        print(f"[17] conv_dict_learning {cfg} unfused f32: losses "
              f"{[float(v) for v in ls_u]}; fused relative {rel.max():.3e} "
              f"(rtol 1e-4 at every step); max |W_fused - W_unfused| "
              f"{float((W_f - W_u).abs().max()):.3e}")
        check(bool((rel <= 1e-4).all()) and conv_launches(before) == [0, 0],
              f"conv DL {cfg}: fused f32 losses against the unfused route")
        del xs, fused
    return launches


def support_parts(zf, zp):
    """(entries where two codes' supports part, a mask of the samples whose
    supports agree)."""
    part = ((zf.abs() > SUPPORT_EPS) != (zp.abs() > SUPPORT_EPS)).reshape(
        zf.shape[0], -1)
    return int(part.sum()), ~part.any(dim=1)


def worst_row(zf, zp):
    """The largest relative difference of one sample's codes."""
    zf, zp = zf.reshape(zf.shape[0], -1), zp.reshape(zp.shape[0], -1)
    num = torch.linalg.vector_norm(zf - zp, dim=1)
    den = torch.linalg.vector_norm(zp, dim=1).clamp_min(1e-30)
    return float((num / den).max())


def implicit_gradient(enc, x, W, alpha):
    """The gradient of sum(z^2) with respect to x and W through ``enc``,
    run twice: first under CUDA's sync debug mode (forward and backward
    apart), then timed, forward and backward apart, with the forward's
    launches (counts set to 0 just before it and read just after) and the
    backward's CG iterations."""
    def once():
        xg, Wg = x.clone().requires_grad_(), W.clone().requires_grad_()
        return xg, Wg, enc(xg, Wg, alpha)

    (xg, Wg, z), fwd_syncs = count_syncs(once)
    _, bwd_syncs = count_syncs(lambda: torch.sum(z ** 2).backward())
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    xg, Wg, z = once()
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    INNER_ITERATIONS.clear()
    t0 = time.perf_counter()
    torch.sum(z ** 2).backward()
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t0
    return types.SimpleNamespace(
        z=z.detach(), gx=xg.grad, gW=Wg.grad, t_fwd=t_fwd, t_bwd=t_bwd,
        syncs=(fwd_syncs, bwd_syncs),
        cg=INNER_ITERATIONS["conjgrad_per_row"], launches=launches)


def check_implicit_launches(kind, fused, plain):
    """Each of the encoder's kernels launched once an iteration in the
    fused forward, and no kernel in the unfused one."""
    reached = {name: fused.launches.get(name, 0)
               for name in IMPLICIT_KERNELS[kind]}
    check(set(reached.values()) == {IMPLICIT_ITERS} and not plain.launches,
          f"implicit {kind}: forward launches {reached} (want "
          f"{IMPLICIT_ITERS} each), unfused {plain.launches} (want none)")


def rel_norm(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def phase_implicit():
    """Implicit gradients at full width: the linear encoder (K1 + K2) and
    the group encoder (K1 + K2 + K5) at 16384x512->2048, the conv encoder
    (K9a + K9b) at conv_fused_bench.py's headline; each held to the same
    gradient with use_pallas=False, and the linear and group ones again
    with a ridge. Returns the forward launches of the timed runs."""
    x_np, W_np = group_problem()
    x, W = torch.from_numpy(x_np).to(DEV), torch.from_numpy(W_np).to(DEV)
    lr = float(1.0 / lipschitz_constant(W))
    xs_c, Wc_np = conv_problem("headline", 1)
    xc, Wc = torch.from_numpy(xs_c[0]).to(DEV), torch.from_numpy(Wc_np).to(DEV)
    lr_c = float(1.0 / lip_bound_conv2d(Wc, 0))
    solve = dict(maxiter=IMPLICIT_ITERS, tol=0.0, cg_iters=IMPLICIT_CG,
                 support_eps=SUPPORT_EPS)
    encoders = {
        "linear": (lambda **kw: make_implicit_encoder(lr=lr, **solve, **kw),
                   x, W),
        "group": (lambda **kw: make_implicit_group_encoder(
            groups=GS, lr=GROUP_LR, **solve, **kw), x, W),
        "conv": (lambda **kw: make_implicit_conv_encoder(
            lr=lr_c, **solve, **kw), xc, Wc)}
    launches = collections.Counter()
    for kind, (make, xi, Wi) in encoders.items():
        run = implicit_gradient(make(), xi, Wi, GROUP_ALPHA)
        launches.update(run.launches)
        plain = implicit_gradient(make(use_pallas=False), xi, Wi,
                                  GROUP_ALPHA)
        check_implicit_launches(kind, run, plain)
        parting, agree = support_parts(run.z, plain.z)
        row = worst_row(run.z, plain.z)
        support = (run.z != 0).reshape(run.z.shape[0], -1).sum(dim=1).float()
        gx = run.gx.reshape(agree.shape[0], -1)
        gx_p = plain.gx.reshape(agree.shape[0], -1)
        rx, rW = rel_norm(run.gx, plain.gx), rel_norm(run.gW, plain.gW)
        r_agree = rel_norm(gx[agree], gx_p[agree])
        finite = all(bool(torch.isfinite(g).all())
                     for g in (run.gx, run.gW, plain.gx, plain.gW))
        print(f"[17] implicit {kind} {tuple(xi.shape)} -> {tuple(run.z.shape)}: "
              f"{run.t_fwd + run.t_bwd:.4f} s a gradient (forward "
              f"{run.t_fwd:.4f}, backward {run.t_bwd:.4f}; unfused forward "
              f"{plain.t_fwd:.4f}, backward {plain.t_bwd:.4f}); backward CG "
              f"iterations {run.cg}, syncs forward / backward {run.syncs}; "
              f"forward launches {json.dumps(run.launches)}; support a "
              f"sample mean {float(support.mean()):.2f}, max "
              f"{float(support.max()):g}; against use_pallas=False: supports "
              f"part on {parting} entries ({int((~agree).sum())} samples), "
              f"x grad relative {rx:.3e}, W grad {rW:.3e} (bound "
              f"{IMPLICIT_BOUND[kind]:g}), x grad on the agreeing samples "
              f"{r_agree:.3e}; codes of the worst sample relative {row:.3e} "
              f"(bound {ROW_CODE_BOUND:g})")
        check(finite and parting <= PARTING_SHARE * run.z.numel()
              and max(rx, rW) <= IMPLICIT_BOUND[kind]
              and row <= ROW_CODE_BOUND,
              f"implicit {kind}: fused against plain")
        if kind != "conv":
            ridged = [implicit_gradient(make(ridge=IMPLICIT_RIDGE, **kw), xi,
                                        Wi, GROUP_ALPHA)
                      for kw in ({}, {"use_pallas": False})]
            launches.update(ridged[0].launches)
            check_implicit_launches(kind, *ridged)
            parting, agree = support_parts(ridged[0].z, ridged[1].z)
            gx, gx_p = ridged[0].gx, ridged[1].gx
            r_agree = rel_norm(gx[agree], gx_p[agree])
            r_part = rel_norm(gx[~agree], gx_p[~agree]) if parting else 0.0
            rW = rel_norm(ridged[0].gW, ridged[1].gW)
            print(f"[17] implicit {kind}, ridge {IMPLICIT_RIDGE}: "
                  f"{ridged[0].t_fwd + ridged[0].t_bwd:.4f} s a gradient, "
                  f"backward CG iterations {ridged[0].cg}; against "
                  f"use_pallas=False: supports part on {parting} entries, x "
                  f"grad on the agreeing samples {r_agree:.3e} (bound "
                  f"{AGREEING_BOUND:g}), on the {int((~agree).sum())} parting "
                  f"samples {r_part:.3e} (bound {PARTING_GRAD_BOUND:g}), W "
                  f"grad {rW:.3e} (bound {W_BOUND:g})")
            check(r_part <= PARTING_GRAD_BOUND,
                  f"implicit {kind}, ridge: parting samples against plain")
        check(r_agree <= AGREEING_BOUND and rW <= W_BOUND,
              f"implicit {kind}: agreeing samples and W against plain")
    return launches


# phase 18: the nonlinear solvers. The full width is the repo's own
# nonlinear configuration, BASELINE.md row 5 and docs/PERFORMANCE.md:161: a
# tanh-MLP decoder x_hat = tanh(z W1) W2 at 2048 x (128 -> 512); the records
# do not name the hidden width, so H = 512. iterative_ridge_bfgs runs at
# K = 256, the widest systems K8 takes (its BFGS state [2048, 256, 256] f32,
# 0.54 GB). Weights are drawn with numpy from a seed, W1 scaled by
# 1 / sqrt(K) and W2 by 1 / sqrt(H) so that tanh does not saturate; x is
# the decoder applied to 5%-sparse codes, plus noise at 0.01.
NL_N, NL_D, NL_K, NL_H, NL_K_IRB = 2048, 128, 512, 512, 256
NL_ALPHA_LINEAR, NL_ALPHA = ALPHA, 0.05
NL_ITERS = 200
# The linear decoder z W^T (unit atoms) against the FISTA anchor, by the
# bound of each solver's JAX test (tests/test_nonlinear.py:56-117). The
# budgets, the smallest that met these bounds on the CPU at 256 rows
# (written in PERF.md before the first run on the card), against the JAX
# tests':
# ista_nl 200 iterations at lr 1/L and 100 at lr 'auto' (3000; 200 read
# 1.1e-6 of the bound's 1e-2), owlqn 50 (150, history 20 as there: 30 read
# 1.0025 f*), iterative_ridge_bfgs 20 from the ridge start (100: 10 read
# 1.0047 f*), split_bregman_nl 20 outer iterations on the flattened batch
# and on one sample (50: 10 read 1.22 f*, 20 1.093), on the batch of one
# Gauss-Newton step a subproblem (5; the residual is linear: 1.0927 f*).
# Each run is timed once, under CUDA's sync debug mode, which also counts
# its synchronizing calls: with three timed runs after a warm-up and a
# 'cg' run on one sample the phase took 197 s on an H100 (PERF.md), with
# one timed run after a warm-up 51.6 and 59.1 s, and it has to stay under
# a minute.
NL_LINEAR_BUDGET = {"ista": 200, "ista auto": 100, "owlqn": 50, "irb": 20,
                    "split_bregman": 20}


def nl_bound(kind, f, f_star):
    """The bound of the solver's JAX test, f against the anchor's f*."""
    if kind == "ista":
        return abs(f - f_star) <= 1e-2 * max(1.0, abs(f_star))
    if kind == "split_bregman":
        return f < 1.15 * f_star + 1e-3
    return f < 1.1 * f_star


# ista_nl at lr 1/L, 200 iterations at tol 0, against sparse_encode's plain
# ista at the same lr: the same iteration with the gradient by autograd, so
# the codes within 1e-4 (written before the first run)
NL_PARITY_ATOL = 1e-4
# The MLP at alpha 0.05: ista_nl 200 iterations at tol 0; owlqn,
# iterative_ridge_bfgs and split_bregman_nl at budgets cut to fit the
# phase's minute (50, 50 and 5 outer iterations of 2 Gauss-Newton steps a
# subproblem, tol 0); lr_refresh=4 within 1e-3 relative of lr_refresh=1
# (DIVERGENCES #15 records ~1e-5). ista_nl at a fixed lr and restarted is
# timed three times after a warm-up run (the median printed), the others
# in their one run under the sync debug mode, which adds the recording of
# a warning at each synchronizing call: an iteration of lr 'auto' took 21
# ms on an H100, and with one timed run after a warm-up the phase took
# 64.0 s on one card's host (PERF.md).
NL_MLP_BUDGET = {"owlqn": 50, "irb": 50, "split_bregman": 5}
NL_REFRESH_RTOL = 1e-3
# The implicit encoders: the linear decoder at full width with ridge 1.0
# and 200 forward iterations against make_implicit_encoder(use_pallas=
# False): parting support entries at most 1e-4 of the codes, the x gradient
# of the samples whose supports agree within 1e-3, the W and alpha
# gradients within 1e-2 (phase 17's bounds with ridge); the MLP in float64
# on 64 rows against central differences along unit directions (step 1e-5;
# a forward of 600 restarted iterations at 0.9 / L, which the CPU saw
# converge to about 1e-13) by the bounds of
# tests/test_implicit_nl.py:45-90
NL_IMPLICIT = {"agreeing_x": 1e-3, "W": 1e-2, "alpha": 1e-2,
               "parting_share": 1e-4, "ridge": 1.0}
NL_FD = {"rows": 64, "iters": 600, "eps": 1e-5, "x": 1e-5, "params": 3e-5,
         "alpha": 1e-4}


def nl_problem(k, seed):
    """Phase 18's inputs as numpy: the MLP's params {'w1': [k, H], 'w2':
    [H, D]}, unit atoms W [D, k], x through the MLP and x through W, both
    from the same 5%-sparse codes."""
    rng = np.random.default_rng(seed)
    params = {"w1": rng.standard_normal((k, NL_H)) / np.sqrt(k),
              "w2": rng.standard_normal((NL_H, NL_D)) / np.sqrt(NL_H)}
    W = rng.standard_normal((NL_D, k))
    W /= np.linalg.norm(W, axis=0, keepdims=True)
    codes = rng.standard_normal((NL_N, k)) * (rng.random((NL_N, k)) < 0.05)
    x_mlp = (np.tanh(codes @ params["w1"]) @ params["w2"]
             + 0.01 * rng.standard_normal((NL_N, NL_D)))
    x_lin = codes @ W.T + 0.01 * rng.standard_normal((NL_N, NL_D))
    return (params, W.astype(np.float32), x_mlp.astype(np.float32),
            x_lin.astype(np.float32))


def mlp_decoder(p):
    return lambda z: torch.tanh(z @ p["w1"]) @ p["w2"]


def nl_losses(dec, x):
    """A decoder's batch loss, per-row losses and residual."""
    return (lambda z: 0.5 * torch.sum(torch.square(dec(z) - x)),
            lambda z: 0.5 * torch.sum(torch.square(dec(z) - x), dim=1),
            lambda z: dec(z) - x)


def nl_objective64(dec64, x, z, alpha):
    """The objective of codes z in float64 on the card, through the
    decoder's float64 twin."""
    r = dec64(z.double()) - x.double()
    return float(0.5 * torch.sum(r * r) + alpha * torch.sum(z.double().abs()))


def nl_timed(call, repeats=1):
    """A first run under CUDA's sync debug mode (its synchronizing calls),
    then ``repeats`` runs timed between two synchronizes (the median kept);
    with ``repeats=0`` the first run's own time, sync debug mode and all."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (z, k), syncs = count_syncs(call)
    torch.cuda.synchronize()
    times = [] if repeats else [time.perf_counter() - t0]
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z, k = call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k = int(k.reshape(-1)[0]) if torch.is_tensor(k) else int(k)
    return types.SimpleNamespace(z=z, n_iter=k, seconds=float(np.median(
        times)), times=times, syncs=syncs, runs=1 + repeats,
        debug_timed=not repeats)


def nl_report(label, run, f, extra=""):
    timed = ("one run under sync debug mode" if run.debug_timed else
             f"median of {len(run.times)} {[round(t, 4) for t in run.times]}")
    print(f"[18] {label}: {run.seconds:.4f} s ({timed}), n_iter {run.n_iter}, "
          f"{run.syncs / max(run.n_iter, 1):.2f} synchronizing calls an "
          f"iteration (sync debug mode), objective f64 {f:.10g}{extra}")


def nl_fd_check(p64, x64, alpha):
    """The MLP's implicit gradients in float64 against central differences:
    ((name, fd, analytic, bound) for x, w1, w2, alpha)."""
    n_rows = x64.shape[0]
    g = torch.Generator(device=DEV).manual_seed(18)
    z0 = torch.zeros(n_rows, p64["w1"].shape[0], dtype=torch.float64,
                     device=DEV)
    dec = lambda pp, z: torch.tanh(z @ pp["w1"]) @ pp["w2"]  # noqa: E731
    L = float(hessian_2norm(lambda z: 0.5 * torch.sum(torch.square(
        dec(p64, z) - x64)), z0, niter=50).max())
    enc = make_implicit_nl_encoder(dec, z0=z0, lr=0.9 / L,
                                   maxiter=NL_FD["iters"], tol=0.0,
                                   restart=True)
    c = torch.randn(z0.shape, generator=g, dtype=torch.float64, device=DEV)
    xg = x64.clone().requires_grad_()
    pg = {k: v.clone().requires_grad_() for k, v in p64.items()}
    ag = torch.tensor(alpha, dtype=torch.float64, device=DEV,
                      requires_grad=True)
    torch.sum(enc(xg, pg, ag) * c).backward()

    def f(xx, pp, aa):
        return float(torch.sum(enc(xx, pp, aa) * c))

    def unit(shape):
        v = torch.randn(shape, generator=g, dtype=torch.float64, device=DEV)
        return v / torch.linalg.vector_norm(v)

    eps, out = NL_FD["eps"], []
    v = unit(x64.shape)
    out.append(("x", (f(x64 + eps * v, p64, alpha) - f(x64 - eps * v, p64,
                                                        alpha)) / (2 * eps),
                float(torch.sum(xg.grad * v)), NL_FD["x"]))
    for leaf in ("w1", "w2"):
        v = unit(p64[leaf].shape)
        fd = (f(x64, {**p64, leaf: p64[leaf] + eps * v}, alpha)
              - f(x64, {**p64, leaf: p64[leaf] - eps * v}, alpha)) / (2 * eps)
        out.append((leaf, fd, float(torch.sum(pg[leaf].grad * v)),
                    NL_FD["params"]))
    out.append(("alpha", (f(x64, p64, alpha + eps) - f(x64, p64, alpha - eps))
                / (2 * eps), float(ag.grad), NL_FD["alpha"]))
    return out, L


def nl_grads(enc, x, params, alpha):
    """The gradient of sum(z^2) through an implicit encoder in x, params (a
    tensor or a dict) and alpha, the forward and the backward timed apart,
    with the backward's CG iterations."""
    xg = x.clone().requires_grad_()
    pg = ({k: v.clone().requires_grad_() for k, v in params.items()}
          if isinstance(params, dict) else params.clone().requires_grad_())
    ag = torch.tensor(alpha, device=DEV, requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = enc(xg, pg, ag)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    INNER_ITERATIONS.clear()
    t0 = time.perf_counter()
    torch.sum(z ** 2).backward()
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        z=z.detach(), gx=xg.grad, ga=ag.grad,
        gp=({k: v.grad for k, v in pg.items()} if isinstance(pg, dict)
            else pg.grad), t_fwd=t_fwd, t_bwd=time.perf_counter() - t0,
        cg=INNER_ITERATIONS["conjgrad_per_row"])


def phase_nonlinear():
    """The nonlinear solvers at BASELINE.md row 5's width: on the linear
    decoder each held to the FISTA anchor by its JAX test's bound; on the
    MLP timed; iterative_ridge_bfgs at K = 256
    launching K8 once an iteration with no LU fallback (the main run of this
    slice: counts set to 0 just before the MLP's iterative_ridge_bfgs runs
    and read just after); K8 alone at B=2048, D=256; the implicit
    encoder. Returns the main run's launch counts and K8's row."""
    t0 = time.perf_counter()
    params_np, W_np, x_mlp_np, x_lin_np = nl_problem(NL_K, seed=18)
    params2_np, W2_np, x_mlp2_np, x_lin2_np = nl_problem(NL_K_IRB, seed=19)
    W, x = torch.from_numpy(W_np).to(DEV), torch.from_numpy(x_lin_np).to(DEV)
    a = NL_ALPHA_LINEAR
    z0 = torch.zeros(NL_N, NL_K, device=DEV)
    lr = float(1.0 / lipschitz_constant(W))
    f_star, drift, z_star = fista_anchor(x, W, a)
    print(f"[18] FISTA anchor, linear decoder {NL_N}x{NL_D}->{NL_K}, alpha "
          f"{a}: objective f64 {f_star:.10g}, half its iterations "
          f"{drift:.3e} above it")
    check(abs(drift) <= 1e-5, "phase 18: the anchor has converged")
    dec = lambda z: z @ W.T  # noqa: E731
    fun, row, resid = nl_losses(dec, x)
    lb = NL_LINEAR_BUDGET
    runs = (
        ("ista_nl lr 1/L", "ista", lambda: ista_nl(
            x, z0, dec, alpha=a, lr=lr, maxiter=lb["ista"], tol=1e-9,
            return_iters=True)),
        ("ista_nl lr auto", "ista", lambda: ista_nl(
            x, z0, dec, alpha=a, maxiter=lb["ista auto"], tol=1e-9,
            return_iters=True)),
        ("owlqn", "owlqn", lambda: owlqn(
            fun, z0, alpha=a, max_iter=lb["owlqn"], xtol=1e-8,
            history_size=20, return_iters=True)),
        ("owlqn per-sample", "owlqn", lambda: owlqn(
            row, z0, alpha=a, max_iter=lb["owlqn"], xtol=1e-8,
            history_size=20, per_sample=True, return_iters=True)),
        ("split_bregman_nl cg, the batch flattened", "split_bregman",
         lambda: split_bregman_nl(
             resid, z0, alpha=a, lambd=1.0, max_iter=lb["split_bregman"],
             lstsq_iter=1, xtol=1e-8, return_iters=True)))
    for label, kind, call in runs:
        run = nl_timed(call, repeats=0)
        f = objective64_dev(x, W, run.z, a)
        nl_report(f"linear, {label}", run, f, f" (f* {f_star:.10g}, "
                  f"{f / f_star:.6f} f*)")
        check(bool(torch.isfinite(run.z).all()) and nl_bound(kind, f, f_star),
              f"phase 18 linear {label}: within its JAX test's bound")
    # 'exact' (a dense Jacobian) on one sample, n = K
    x1 = x[0]
    f1_star = objective64_dev(x[:1], W, z_star[:1], a)
    run = nl_timed(lambda: split_bregman_nl(
        lambda z: W @ z - x1, torch.zeros(NL_K, device=DEV), alpha=a,
        lambd=1.0, max_iter=lb["split_bregman"], xtol=1e-8, solver="exact",
        return_iters=True), repeats=0)
    f = objective64_dev(x[:1], W, run.z[None], a)
    nl_report("linear, split_bregman_nl exact, one sample", run, f,
              f" (f* {f1_star:.10g}, {f / f1_star:.6f} f*)")
    check(nl_bound("split_bregman", f, f1_star),
          "phase 18 split_bregman_nl exact on one sample")
    # the same iteration as the linear ista's, code by code
    z_nl = ista_nl(x, z0, dec, alpha=a, lr=lr, maxiter=NL_ITERS, tol=0.0)
    z_li = sparse_encode(x, W, a, algorithm="ista", lr=lr, maxiter=NL_ITERS,
                         tol=0.0, use_pallas=False)
    err = float((z_nl - z_li).abs().max())
    print(f"[18] ista_nl against sparse_encode's plain ista, {NL_ITERS} "
          f"iterations at lr 1/L: max |dz| {err:.3e} (atol {NL_PARITY_ATOL})")
    check(err <= NL_PARITY_ATOL, "phase 18: ista_nl against the linear ista")

    # iterative_ridge_bfgs at K = 256 on its own anchor, from the ridge
    # start, each run one K8 launch an iteration
    W2 = torch.from_numpy(W2_np).to(DEV)
    x2 = torch.from_numpy(x_lin2_np).to(DEV)
    f2_star, drift, _ = fista_anchor(x2, W2, a)
    check(abs(drift) <= 1e-5, "phase 18: the K = 256 anchor has converged")
    fun2, row2, _ = nl_losses(lambda z: z @ W2.T, x2)
    z0r = linear.initialize_code(x2, W2, a, "ridge")
    for label, f_, ps in (("", fun2, False), (" per-sample", row2, True)):
        before = _cuda.launch_counts()
        run = nl_timed(lambda f_=f_, ps=ps: iterative_ridge_bfgs(
            f_, z0r, alpha=a, maxiter=lb["irb"], xtol=1e-9, per_sample=ps,
            return_iters=True), repeats=0)
        got = {k: v - before.get(k, 0) for k, v in _cuda.launch_counts().items()}
        f = objective64_dev(x2, W2, run.z, a)
        nl_report(f"linear, iterative_ridge_bfgs{label} {NL_N}x{NL_D}->"
                  f"{NL_K_IRB}", run, f, f" (f* {f2_star:.10g}, "
                  f"{f / f2_star:.6f} f*); chol_solve {got.get('chol_solve')}"
                  f", LU {got.get('batch_cholesky_solve_lu', 0)}")
        check(nl_bound("irb", f, f2_star) and got.get("chol_solve") ==
              run.runs * run.n_iter and not got.get(
                  "batch_cholesky_solve_lu"),
              f"phase 18 iterative_ridge_bfgs{label}: bound, K8 once an "
              f"iteration, no LU")
    print(f"[18] {time.perf_counter() - t0:.1f} s into the phase: the linear "
          f"decoder done")

    # the MLP at alpha 0.05, 200 iterations at tol 0
    p = from_numpy_tree(params_np, DEV)
    p64 = from_numpy_tree(params_np, DEV, torch.float64)
    xm = torch.from_numpy(x_mlp_np).to(DEV)
    dec, dec64 = mlp_decoder(p), mlp_decoder(p64)
    fun, row, resid = nl_losses(dec, xm)
    am = NL_ALPHA
    L0 = float(hessian_2norm(fun, z0, niter=50).max())
    lr_m = 0.9 / L0
    f0 = nl_objective64(dec64, xm, z0, am)
    print(f"[18] MLP {NL_N}x({NL_D} -> {NL_K}), H {NL_H}, alpha {am}: the "
          f"Hessian's norm at z = 0 up to {L0:.4f} (lr {lr_m:.5f}); the "
          f"start's objective f64 {f0:.10g}")
    mb = NL_MLP_BUDGET
    runs = (
        ("ista_nl lr 0.9/L", 3, lambda: ista_nl(
            xm, z0, dec, alpha=am, lr=lr_m, maxiter=NL_ITERS, tol=0.0,
            return_iters=True)),
        ("ista_nl lr auto", 0, lambda: ista_nl(
            xm, z0, dec, alpha=am, maxiter=NL_ITERS, tol=0.0,
            return_iters=True)),
        ("ista_nl lr auto, lr_refresh 4", 0, lambda: ista_nl(
            xm, z0, dec, alpha=am, maxiter=NL_ITERS, tol=0.0, lr_refresh=4,
            return_iters=True)),
        ("ista_nl restart", 3, lambda: ista_nl(
            xm, z0, dec, alpha=am, lr=lr_m, maxiter=NL_ITERS, tol=0.0,
            restart=True, return_iters=True)),
        ("owlqn brent", 0, lambda: owlqn(
            fun, z0, alpha=am, max_iter=mb["owlqn"], xtol=0.0,
            return_iters=True)),
        ("owlqn per-sample backtrack", 0, lambda: owlqn(
            row, z0, alpha=am, max_iter=mb["owlqn"], xtol=0.0,
            per_sample=True, line_search="backtrack", return_iters=True)),
        ("split_bregman_nl cg", 0, lambda: split_bregman_nl(
            resid, z0, alpha=am, max_iter=mb["split_bregman"], lstsq_iter=2,
            xtol=0.0, return_iters=True)))
    fs = {}
    for label, repeats, call in runs:
        INNER_ITERATIONS.clear()
        run = nl_timed(call, repeats)
        f = nl_objective64(dec64, xm, run.z, am)
        fs[label] = f
        rate = (f", {run.n_iter / run.seconds:.2f} it/s"
                if label.startswith("ista") else "")
        nl_report(f"MLP, {label}", run, f, f"{rate}; inner iterations "
                  f"{json.dumps(dict(INNER_ITERATIONS))} over its {run.runs} "
                  f"runs")
        check(bool(torch.isfinite(run.z).all()) and f < f0,
              f"phase 18 MLP {label}: finite and below the start")
    rel = (abs(fs["ista_nl lr auto, lr_refresh 4"] - fs["ista_nl lr auto"])
           / abs(fs["ista_nl lr auto"]))
    print(f"[18] lr_refresh 4 against 1: {rel:.3e} relative (bound "
          f"{NL_REFRESH_RTOL})")
    check(rel <= NL_REFRESH_RTOL, "phase 18: lr_refresh 4 near 1")

    # iterative_ridge_bfgs through the MLP at K = 256: the main run
    p2 = from_numpy_tree(params2_np, DEV)
    p2_64 = from_numpy_tree(params2_np, DEV, torch.float64)
    xm2 = torch.from_numpy(x_mlp2_np).to(DEV)
    fun2, row2, _ = nl_losses(mlp_decoder(p2), xm2)
    z0m = 0.1 * torch.randn(NL_N, NL_K_IRB, device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(
                                19))
    f0m = nl_objective64(mlp_decoder(p2_64), xm2, z0m, am)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    irb_runs = []
    for label, f_, ps in (("", fun2, False), (" per-sample", row2, True)):
        before = _cuda.launch_counts()
        run = nl_timed(lambda f_=f_, ps=ps: iterative_ridge_bfgs(
            f_, z0m, alpha=am, maxiter=mb["irb"], xtol=0.0, per_sample=ps,
            return_iters=True), repeats=0)
        got = {k: v - before.get(k, 0) for k, v in _cuda.launch_counts().items()}
        irb_runs.append((label, run, got))
    counts = _cuda.launch_counts()
    for label, run, got in irb_runs:
        f = nl_objective64(mlp_decoder(p2_64), xm2, run.z, am)
        nl_report(f"MLP, iterative_ridge_bfgs{label} K={NL_K_IRB}", run, f,
                  f" (start {f0m:.10g}); chol_solve {got.get('chol_solve')} "
                  f"for {run.runs} runs, LU {got.get('batch_cholesky_solve_lu', 0)}")
        check(bool(torch.isfinite(run.z).all()) and f < f0m,
              f"phase 18 MLP iterative_ridge_bfgs{label}: finite, below start")
        check(got.get("chol_solve") == run.runs * run.n_iter
              and not got.get("batch_cholesky_solve_lu"),
              f"phase 18 MLP iterative_ridge_bfgs{label}: K8 once an "
              f"iteration, no LU")
    print(f"[18] main run launch counts: "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")

    # where an iteration's time goes: short runs of each solver on the MLP
    # under torch.profiler (the host's operations traced too), their
    # kernel time by name against the wall time of the same run untraced
    short = (
        ("ista_nl lr 0.9/L", lambda: ista_nl(
            xm, z0, dec, alpha=am, lr=lr_m, maxiter=10, tol=0.0)),
        ("ista_nl lr auto", lambda: ista_nl(
            xm, z0, dec, alpha=am, maxiter=3, tol=0.0)),
        ("owlqn brent", lambda: owlqn(fun, z0, alpha=am, max_iter=5,
                                      xtol=0.0)),
        ("split_bregman_nl cg", lambda: split_bregman_nl(
            resid, z0, alpha=am, max_iter=1, inner_iter=1, lstsq_iter=1,
            xtol=0.0)),
        ("iterative_ridge_bfgs K=256", lambda: iterative_ridge_bfgs(
            fun2, z0m, alpha=am, maxiter=5, xtol=0.0)))
    for label, call in short:
        call()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        _, by_name = profiled(call)
        k8 = sum(v for k, v in by_name.items() if "chol_solve" in k)
        print(f"[18] split of a short MLP run, {label}: wall {wall:.4f} s; "
              f"{kernel_split(by_name, wall)}; K8 {k8:.3f} ms")
    print(f"[18] {time.perf_counter() - t0:.1f} s into the phase: the MLP "
          f"done")

    # K8 alone at the shape the main run gives it, held to its plain
    # version (phase 12's rule) and timed beside it, the library and its
    # bound
    b, A = spd_systems(NL_N, NL_K_IRB, seed=18)
    got = B.batch_cholesky_solve_lanes(b, A)
    torch.cuda.synchronize()
    want = B.batch_cholesky_solve_lanes_plain(b, A)
    worst = rel_excess(got, want, 1e-4)
    err = float((got - want).abs().max())
    print(f"[18] chol_solve B={NL_N} D={NL_K_IRB}: max|err| {err:.3e}, "
          f"max(|err| - 1e-4 |plain|) {worst:.3e} (atol 1e-5)")
    check(worst <= 1e-5 and bool(torch.isfinite(got).all()),
          f"chol_solve B={NL_N} D={NL_K_IRB}")
    del got, want

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[:, :, None], L)

    t_bytes, t_ops = chol_solve_bound_ms(NL_N, NL_K_IRB)
    k8_row = {"name": "chol_solve", "shape": f"B={NL_N}, D={NL_K_IRB}",
              "route": "cuda", "source": CHOL_SOURCE,
              "replaces": CHOL_SOLVE_REPLACES,
              "launches": counts.get("chol_solve", 0), "max_abs_err": err,
              "ms": cuda_ms(lambda: B.batch_cholesky_solve_lanes(b, A)),
              "plain_ms": cuda_ms(
                  lambda: B.batch_cholesky_solve_lanes_plain(b, A), reps=1,
                  warm=0),
              "bound_ms": max(t_bytes, t_ops),
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              "library_ms": 1e3 * sum(kernel_seconds(library)
                                      for _ in range(3)) / 3}
    print(f"[18] {json.dumps(k8_row)} (ms: mean of 20 launches after 3; "
          f"plain_ms: one call; library_ms: torch.linalg.cholesky_ex + "
          f"torch.cholesky_solve, the card time of its operations by "
          f"torch.profiler, mean of 3 calls, timed only)")
    del b, A

    # the implicit encoder: the linear decoder at full width, ridge 1.0,
    # against the linear implicit encoder on the same forward iteration
    solve = dict(lr=lr, maxiter=NL_ITERS, tol=0.0, ridge=NL_IMPLICIT["ridge"],
                 cg_iters=IMPLICIT_CG, support_eps=SUPPORT_EPS)
    nl = nl_grads(make_implicit_nl_encoder(lambda Wp, z: z @ Wp.T, z0=z0,
                                           **solve), x, W, a)
    li = nl_grads(make_implicit_encoder(use_pallas=False, **solve), x, W, a)
    parting, agree = support_parts(nl.z, li.z)
    r_agree = rel_norm(nl.gx[agree], li.gx[agree])
    rW, ra = rel_norm(nl.gp, li.gp), rel_norm(nl.ga, li.ga)
    finite = all(bool(torch.isfinite(v).all())
                 for v in (nl.gx, nl.gp, nl.ga))
    print(f"[18] implicit, linear decoder {NL_N}x{NL_D}->{NL_K}, ridge "
          f"{NL_IMPLICIT['ridge']}: forward {nl.t_fwd:.4f} s, backward "
          f"{nl.t_bwd:.4f} s ({nl.cg} CG iterations; the linear encoder "
          f"{li.t_fwd:.4f} + {li.t_bwd:.4f} s, {li.cg}); supports part on "
          f"{parting} entries ({int((~agree).sum())} samples); x grad on the "
          f"agreeing samples {r_agree:.3e} (bound "
          f"{NL_IMPLICIT['agreeing_x']:g}), W grad {rW:.3e}, alpha grad "
          f"{ra:.3e} (bounds {NL_IMPLICIT['W']:g}, {NL_IMPLICIT['alpha']:g})")
    check(finite and parting <= NL_IMPLICIT["parting_share"] * nl.z.numel()
          and r_agree <= NL_IMPLICIT["agreeing_x"] and rW <= NL_IMPLICIT["W"]
          and ra <= NL_IMPLICIT["alpha"],
          "phase 18: the nonlinear implicit encoder against the linear one")
    del nl, li

    # the MLP in float64 on 64 rows against central differences
    fd, L_fd = nl_fd_check(p64, xm[:NL_FD["rows"]].double(), am)
    for name, f_d, an, bound in fd:
        print(f"[18] implicit, MLP float64 {NL_FD['rows']} rows (lr 0.9 / "
              f"{L_fd:.4f}, {NL_FD['iters']} restarted iterations): "
              f"d/d{name} central difference {f_d:.10g}, implicit "
              f"{an:.10g}, relative {abs(f_d - an) / max(1.0, abs(f_d)):.3e}"
              f" (bound {bound:g})")
        check(abs(f_d - an) <= bound * max(1.0, abs(f_d)),
              f"phase 18: the MLP's implicit d/d{name}")

    # the MLP in float32 at full width: time and CG iterations
    run = nl_grads(make_implicit_nl_encoder(
        lambda pp, z: torch.tanh(z @ pp["w1"]) @ pp["w2"], z0=z0, lr=lr_m,
        maxiter=NL_ITERS, tol=0.0, cg_iters=IMPLICIT_CG), xm, p, am)
    finite = all(bool(torch.isfinite(v).all())
                 for v in (run.gx, run.ga, *run.gp.values()))
    print(f"[18] implicit, MLP float32 {NL_N}x({NL_D} -> {NL_K}): forward "
          f"{run.t_fwd:.4f} s ({NL_ITERS} iterations), backward "
          f"{run.t_bwd:.4f} s ({run.cg} CG iterations), support a sample "
          f"{float((run.z != 0).sum(dim=1).float().mean()):.2f}, gradients "
          f"finite {finite}")
    check(finite, "phase 18: the MLP's implicit gradients finite")
    return counts, k8_row


# phase 19: the parallel layer (lasso_tpu_torch.parallel) on
# torch.distributed. One NCCL rank on an in-memory store (no network): the
# headline encode bit for bit with sparse_encode and with the same K1/K2
# launches, 3 EM steps at the training width and the conv encode and 3
# conv EM steps at the conv headline, each held to its single-process
# counterpart. Then two processes sharing the card over gloo (NCCL refuses
# two ranks on one device), 8192 rows each: codes within the JAX test's
# 1e-5 and the same count, also ragged (16383 rows). Seconds are medians
# of PAR_REPS calls a side (PAR_STEPS EM steps; the gloo ranks' of
# PAR_GLOO_REPS).
PAR_KW = dict(algorithm="ista", maxiter=200, tol=1e-5,
              kernel_precision="mixed", mixed_tail_iters=37,
              return_iters=True)
PAR_ATOL = 1e-5                  # tests/test_parallel.py's sharded encodes
PAR_RAGGED = 16383
PAR_TRAIN = dict(lambd=1e-2, maxiter=100, tol=1e-5)
PAR_CONV = dict(maxiter=CONV_ITERS, tol=1e-5)
PAR_STEPS = 5
PAR_REPS = 5
PAR_GLOO_REPS = 3
PAR_RANK_TIMEOUT = 240


def timed(fn):
    """(result, seconds) of one call between two synchronizes."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def par_call(fn, total):
    """One call of the parallel layer with the launch counts set to 0 just
    before it and read just after, added to ``total``: (result, seconds,
    the call's own counts)."""
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    out, seconds = timed(fn)
    counts = _cuda.launch_counts()
    total.update(counts)
    return out, seconds, counts


def par_print(label, seconds, single):
    """Medians of a parallel call's and its single-process counterpart's
    seconds, each call's beside them."""
    med, med_s = float(np.median(seconds)), float(np.median(single))
    print(f"[19] {label}: median {med:.4f} s, single process {med_s:.4f} s "
          f"({med / med_s:.3f}x); calls "
          f"{json.dumps([round(t, 4) for t in seconds])}, single "
          f"{json.dumps([round(t, 4) for t in single])}")


def host_split(label, fn):
    """One call of ``fn`` under torch.profiler with the host's operations
    traced: print its kernel time by name (:func:`profiled`'s rule), the
    NCCL kernels' share, and the host's costliest operations by self time
    with their call counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev, host = collections.Counter(), {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if e.self_device_time_total > 0:
                dev[e.key[:40]] += e.self_device_time_total / 1e3
        elif e.self_cpu_time_total > 0:
            host[e.key[:40]] = (round(e.self_cpu_time_total / 1e3, 3),
                                e.count)
    nccl = sum(v for k, v in dev.items() if "nccl" in k.lower())
    top = dict(sorted(host.items(), key=lambda kv: -kv[1][0])[:8])
    print(f"[19] {label} under torch.profiler: wall {wall:.4f} s, "
          f"{kernel_split(dev, wall)}, NCCL kernels {nccl:.3f} ms; host "
          f"self ms and calls {json.dumps(top)}")


def parallel_encode_rank(rank, world, directory):
    """One of the two gloo ranks of phase 19 (``chip_smoke.py
    --parallel-rank RANK WORLD DIR``): the headline encode and the ragged
    one through data_parallel_encode, each after a short warm-up call and
    timed PAR_GLOO_REPS times; rank 0 saves the last codes and count and
    every call's seconds to DIR."""
    import torch.distributed as dist

    from lasso_tpu_torch import parallel
    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(directory, "store"), world)
    parallel.initialize(num_processes=world, process_id=rank,
                        backend="gloo", store=store)
    mesh = parallel.make_mesh(devices="cuda")
    x_np, W_np = headline_problem()
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    lr = float(np.load(os.path.join(directory, "lr.npy")))
    out = {}
    for label, rows in (("headline", N), ("ragged", PAR_RAGGED)):
        parallel.data_parallel_encode(mesh, x[:rows], W, alpha=ALPHA, lr=lr,
                                      **{**PAR_KW, "maxiter": 8})
        seconds = []
        for _ in range(PAR_GLOO_REPS):
            (z, k), s = timed(lambda: parallel.data_parallel_encode(
                mesh, x[:rows], W, alpha=ALPHA, lr=lr, **PAR_KW))
            seconds.append(s)
        out[label] = (z.cpu(), k, seconds)
    if rank == 0:
        torch.save(out, os.path.join(directory, "rank0.pt"))
    dist.destroy_process_group()
    return 0


def two_gloo_ranks(lr):
    """Run phase 19's two gloo ranks and return rank 0's results; a rank
    that fails or outlives PAR_RANK_TIMEOUT kills both and fails."""
    with tempfile.TemporaryDirectory() as directory:
        np.save(os.path.join(directory, "lr.npy"), np.float32(lr))
        env = dict(os.environ, PYTHONPATH=ROOT)
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), "2", directory], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=PAR_RANK_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print(logs[r], file=sys.stderr)
            check(p.returncode == 0, f"phase 19 gloo rank {r} exited "
                  f"{p.returncode}")
        return torch.load(os.path.join(directory, "rank0.pt"))


def phase_parallel(x_np, W_np, X_train):
    """Phase 19; returns the launches of its one-rank parallel calls by
    kernel (the single-process references run outside their counts)."""
    import torch.distributed as dist

    from lasso_tpu_torch import parallel
    from lasso_tpu_torch.conv2d.dict_learning import conv_lasso_loss
    from lasso_tpu_torch.conv2d.ops import _code_shape

    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    lr = float(1.0 / lipschitz_constant(W))
    kw = dict(alpha=ALPHA, lr=lr, **PAR_KW)
    card = card_line()

    # the single-process references, warm
    sparse_encode(x, W, **{**kw, "maxiter": 8})
    _cuda.reset_launch_counts()
    z_s, k_s = sparse_encode(x, W, **kw)
    single_counts = _cuda.launch_counts()
    z_r, k_r = sparse_encode(x[:PAR_RAGGED], W, **kw)
    s_single, s_ragged = [], []
    for _ in range(PAR_REPS):
        s_single.append(timed(lambda: sparse_encode(x, W, **kw))[1])
        s_ragged.append(timed(lambda: sparse_encode(x[:PAR_RAGGED], W,
                                                    **kw))[1])

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(devices="cuda")
        check(tuple(mesh.shape) == (1, 1), "phase 19: a (1, 1) mesh")
        # the communicator is made at the first collective: outside the
        # timed calls
        parallel.data_parallel_encode(mesh, x, W, **{**kw, "maxiter": 8})
        total = collections.Counter()
        names = [f"{k}_{kp}" for k in ("fista_resid", "fista_grad_prox")
                 for kp in ("bf16", "f32")]
        s_par = []
        for i in range(PAR_REPS):
            (z_p, k_p), s, counts = par_call(
                lambda: parallel.data_parallel_encode(mesh, x, W, **kw),
                total)
            s_par.append(s)
            if i == 0:
                print(f"[19] one NCCL rank, {card}: n_iter {k_p} (single "
                      f"process {k_s}), launches "
                      f"{json.dumps({n: counts.get(n, 0) for n in names})}")
            check(torch.equal(z_p, z_s) and k_p == k_s,
                  "phase 19: one rank bit for bit with sparse_encode")
            check(all(counts.get(n, 0) == single_counts.get(n, 0) > 0
                      for n in names),
                  "phase 19: the same K1/K2 launches as sparse_encode")
        par_print("data_parallel_encode at the headline, one rank", s_par,
                  s_single)

        # EM steps at the training width, against sparse_encode +
        # lasso_loss + update_dict_ridge in one process
        X = torch.from_numpy(X_train).to(DEV)
        g = torch.Generator(device=DEV).manual_seed(19)
        W0 = torch.randn(TRAIN_D, TRAIN_K, generator=g, device=DEV)
        W0 = W0 / torch.linalg.vector_norm(W0, dim=0, keepdim=True)
        step, _ = parallel.make_train_step(mesh, alpha=ALPHA, **PAR_TRAIN)
        solver = {k: v for k, v in PAR_TRAIN.items() if k != "lambd"}

        def single_step(w):
            Z = sparse_encode(X, w, ALPHA, **solver)
            return (DL.update_dict_ridge(X, Z, lambd=PAR_TRAIN["lambd"]),
                    DL.lasso_loss(X, Z, w, ALPHA))

        # a step of each outside the timed ones: the first call of a
        # solver, a Cholesky or a convolution pays for its library's set-up
        step(X, W0)
        single_step(W0)
        w_p = w_s = W0
        t_p, t_s = [], []
        for i in range(PAR_STEPS):
            (w_p, loss_p), s, _ = par_call(lambda: step(X, w_p), total)
            t_p.append(s)
            (w_s, loss_s), s = timed(lambda: single_step(w_s))
            t_s.append(s)
            print(f"[19] train step {i}: loss {float(loss_p):.8g} (single "
                  f"{float(loss_s):.8g}), W bit for bit "
                  f"{torch.equal(w_p, w_s)}")
            check(torch.equal(w_p, w_s) and torch.equal(loss_p, loss_s),
                  "phase 19: make_train_step bit for bit with the single "
                  "step")
        par_print(f"make_train_step, an EM step at "
                  f"{TRAIN_N}x{TRAIN_D}->{TRAIN_K}", t_p, t_s)

        # the conv encode and conv EM steps at the conv headline
        xs_np, Wc_np = conv_problem("headline", 1)
        xc = torch.from_numpy(xs_np[0]).to(DEV)
        Wc = torch.from_numpy(Wc_np).to(DEV)
        lr_c = float(1.0 / lip_bound_conv2d(Wc, 0))
        zc0 = xc.new_zeros(_code_shape(xc.shape, Wc.shape))
        ista_conv2d(xc, zc0, Wc, CONV_ALPHA, lr=lr_c, **PAR_CONV)
        parallel.data_parallel_encode_conv2d(mesh, xc, Wc, alpha=CONV_ALPHA,
                                             lr=lr_c, **PAR_CONV)
        s_cs, s_cp = [], []
        for _ in range(PAR_REPS):
            zc_s, s = timed(lambda: ista_conv2d(xc, zc0, Wc, CONV_ALPHA,
                                                lr=lr_c, **PAR_CONV))
            s_cs.append(s)
            zc_p, s, _ = par_call(
                lambda: parallel.data_parallel_encode_conv2d(
                    mesh, xc, Wc, alpha=CONV_ALPHA, lr=lr_c, **PAR_CONV),
                total)
            s_cp.append(s)
            check(torch.equal(zc_p, zc_s),
                  "phase 19: the conv encode bit for bit with ista_conv2d")
        par_print("data_parallel_encode_conv2d at the conv headline", s_cp,
                  s_cs)
        cstep, _ = parallel.make_conv_train_step(
            mesh, alpha=CONV_ALPHA, lr=lr_c, **PAR_CONV)

        def conv_single(w, gen):
            Z = ista_conv2d(xc, xc.new_zeros(_code_shape(xc.shape, w.shape)),
                            w, CONV_ALPHA, lr=lr_c, **PAR_CONV)
            loss = conv_lasso_loss(xc, Z, w, CONV_ALPHA)
            return update_kernel_constrained(xc, Z, w, gen)[0], loss

        # cuDNN's default weight gradient (the M-step's adjoint) does not
        # repeat its last bits from call to call; with its deterministic
        # algorithms on both sides the step is held bit for bit
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            cstep(xc, Wc, torch.Generator(device=DEV).manual_seed(0))
            conv_single(Wc, torch.Generator(device=DEV).manual_seed(0))
            w_p = w_s = Wc
            t_p, t_s = [], []
            for i in range(PAR_STEPS):
                (w_p, loss_p), s, _ = par_call(lambda: cstep(
                    xc, w_p, torch.Generator(device=DEV).manual_seed(i)),
                    total)
                t_p.append(s)
                (w_s, loss_s), s = timed(lambda: conv_single(
                    w_s, torch.Generator(device=DEV).manual_seed(i)))
                t_s.append(s)
                print(f"[19] conv train step {i}: loss {float(loss_p):.8g} "
                      f"(single {float(loss_s):.8g}), W bit for bit "
                      f"{torch.equal(w_p, w_s)}")
                check(torch.equal(w_p, w_s) and torch.equal(loss_p, loss_s),
                      "phase 19: make_conv_train_step bit for bit with the "
                      "single step")
            par_print(f"make_conv_train_step, an EM step (deterministic "
                      f"cuDNN)", t_p, t_s)
            # where a conv step's time goes on each side (outside the
            # launch counts)
            for label, call in (
                    ("make_conv_train_step", lambda: cstep(
                        xc, w_p, torch.Generator(device=DEV).manual_seed(9))),
                    ("the single-process conv step", lambda: conv_single(
                        w_s, torch.Generator(device=DEV).manual_seed(9)))):
                host_split(label, call)
        finally:
            torch.backends.cudnn.deterministic = deterministic
    finally:
        dist.destroy_process_group()

    got = two_gloo_ranks(lr)
    for label, z_ref, k_ref, single in (
            ("headline", z_s, k_s, s_single),
            ("ragged", z_r, k_r, s_ragged)):
        z, k, s = got[label]
        err = float(torch.max(torch.abs(z.to(DEV) - z_ref)))
        print(f"[19] two gloo ranks, {label} ({z.shape[0]} rows): n_iter "
              f"{k} (single process {k_ref}), max |z - z_single| {err:.3e}")
        par_print(f"two gloo ranks sharing the card, {label}", s, single)
        check(tuple(z.shape) == tuple(z_ref.shape) and err <= PAR_ATOL
              and k == k_ref,
              f"phase 19: two gloo ranks, {label}, within {PAR_ATOL} and "
              f"the same count")
    return total


# phase 20: the last modules. (a) the native patch pipeline at BASELINE.md
# row 4 (benchmarks/dict_learning_bench.py:40-58: 400 stroke images 28x28,
# 8x8 patches, 41 an image, seed 0, centred, the first 16384); (b) CSR
# serving at phase 4's width; (c) an exported encoder at the headline;
# (d) resumable training on (a)'s patches (16384x64 -> 256, alpha 0.1,
# sequential M-step, 10 EM steps of 50-iteration E-steps, a checkpoint
# every 3); (e) typed configs and the profiling helpers
DL_IMAGES, DL_PATCH, DL_PER_IMAGE, DL_N, DL_K = 400, 8, 41, 16384, 256
DL_KW = dict(alpha=0.1, constrained=True, dict_update="sequential",
             steps=10, maxiter=50, tol=0.0)
DL_SAVE_EVERY, DL_KEEP = 3, 6
EXPORT_KW = dict(maxiter=200, tol=1e-5, kernel_precision="mixed")
EXPORT_ROWS = (16384, 4096)
RESULTS = {}


def make_stroke_images(n_images=200, size=28, seed=0):
    """Random-walk 'strokes' on a grid (a numpy copy of
    examples/dict_learning_patches.py:25)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n_images, size, size), np.float32)
    for i in range(n_images):
        n_strokes = rng.integers(2, 5)
        for _ in range(n_strokes):
            x, y = rng.integers(4, size - 4, size=2).astype(float)
            vx, vy = rng.normal(size=2)
            for _ in range(rng.integers(8, 20)):
                xi, yi = int(round(x)), int(round(y))
                if 0 <= xi < size and 0 <= yi < size:
                    imgs[i, yi, xi] = 1.0
                    for dx, dy in ((0, 1), (1, 0)):
                        if 0 <= yi + dy < size and 0 <= xi + dx < size:
                            imgs[i, yi + dy, xi + dx] = max(
                                imgs[i, yi + dy, xi + dx], 0.5)
                vx += rng.normal() * 0.6
                vy += rng.normal() * 0.6
                n = max(1.0, np.hypot(vx, vy))
                x += vx / n * 1.5
                y += vy / n * 1.5
    return imgs


def host_timed(fn):
    """(result, seconds) of one host call."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def numpy_native(fn):
    """``fn()`` with the native library hidden: the numpy versions."""
    get_lib = native.get_lib
    native.get_lib = lambda: None
    try:
        return fn()
    finally:
        native.get_lib = get_lib


def phase_native():
    """(a): the build, the patch pipeline against its numpy versions, and
    the training patches."""
    lib, secs = host_timed(native.get_lib)
    check(lib is not None and native.have_native(),
          "the native library builds with g++")
    print(f"[20a] native library {native.library_path().name} built and "
          f"loaded in {secs:.3f} s")
    imgs, t_imgs = host_timed(lambda: make_stroke_images(DL_IMAGES, 28, 0))
    dense, t_dense = host_timed(
        lambda: native.extract_patches_dense(imgs, DL_PATCH))
    dense_np = numpy_native(
        lambda: native.extract_patches_dense(imgs, DL_PATCH))
    check(np.array_equal(dense, dense_np),
          "dense patches equal the numpy version")
    centred, t_center = host_timed(
        lambda: native.center_patches(dense.copy()))
    for normalize in (False, True):
        c_nat = native.center_patches(dense.copy(), normalize=normalize)
        c_np = numpy_native(
            lambda: native.center_patches(dense.copy(), normalize=normalize))
        err = float(np.abs(c_nat - c_np).max())
        check(err <= 1e-6, f"centring (normalize={normalize}) within 1e-6 "
              f"of the numpy version: {err:.3e}")
    rand, t_rand = host_timed(lambda: native.extract_patches_random(
        imgs, DL_PATCH, DL_PER_IMAGE, seed=0))
    check(np.array_equal(rand, native.extract_patches_random(
        imgs, DL_PATCH, DL_PER_IMAGE, seed=0)), "random patches repeat")
    check(np.array_equal(rand, native.extract_patches_random(
        imgs, DL_PATCH, DL_PER_IMAGE, seed=0, threads=1)),
        "random patches equal at threads=1")
    windows = dense.reshape(DL_IMAGES, -1, DL_PATCH * DL_PATCH)
    valid = all(
        set(p.tobytes() for p in rand[i * DL_PER_IMAGE:
                                      (i + 1) * DL_PER_IMAGE])
        <= set(w.tobytes() for w in windows[i]) for i in range(DL_IMAGES))
    check(valid, "every random patch is a window of its image")
    X, t_x = host_timed(lambda: native.center_patches(rand)[:DL_N])
    print(f"[20a] {DL_IMAGES} stroke images {t_imgs:.3f} s; dense patches "
          f"{dense.shape} {t_dense:.4f} s, centred {t_center:.4f} s (equal "
          f"to the numpy versions); random patches {rand.shape} "
          f"{t_rand:.4f} s, centred {t_x:.4f} s, repeatable, equal at one "
          f"thread, every one a window of its image; card {card_line()}")
    check(X.shape == (DL_N, DL_PATCH * DL_PATCH), "training patches")
    return X


def phase_csr_serving():
    """(b): chunked dense and CSR output at phase 4's width, and the CLI's
    ``encode --csr``; returns their K1/K2 launches."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((CLI_ROWS, D)).astype(np.float32)
    W = (rng.standard_normal((D, K)) / np.sqrt(D)).astype(np.float32)
    Wd = torch.from_numpy(W).to(DEV)
    kw = dict(alpha=ALPHA, chunk_size=CLI_CHUNK, maxiter=100, tol=0.0,
              kernel_precision="f32")
    launches = collections.Counter()
    pack = native.pack_codes_csr
    packing = []

    def timed_pack(*a, **k):
        out, secs = host_timed(lambda: pack(*a, **k))
        packing.append(secs)
        return out

    def run(**extra):
        _cuda.reset_launch_counts()
        out, secs = timed(lambda: chunked_encode(x, Wd, **kw, **extra))
        counts = _cuda.launch_counts()
        launches.update(counts)
        return out, secs, {k: counts.get(k, 0) for k in
                           ("fista_resid_f32", "fista_grad_prox_f32")}

    run()   # the first call of the kernels and of the host's copies
    dense, t_dense, n_dense = run()
    native.pack_codes_csr = timed_pack
    try:
        (v, c, rp), t_csr, n_csr = run(output="csr")
    finally:
        native.pack_codes_csr = pack
    check(np.array_equal(native.unpack_codes_csr(v, c, rp, K), dense),
          "CSR output unpacks to the dense codes bit for bit")
    check(int(rp[-1]) == int(np.count_nonzero(dense)),
          "row_ptr[-1] is the dense nonzero count")
    check(n_dense == n_csr and min(n_dense.values()) > 0,
          f"dense and CSR launch the same K1/K2: {n_dense} {n_csr}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("X.npy", "W.npy")]
        np.save(paths[0], x)
        np.save(paths[1], W)
        argv = sys.argv
        sys.argv = ["lasso_tpu_torch", "encode", *paths, "--csr", "-o",
                    os.path.join(tmp, "Z.npy"), "--alpha", str(ALPHA),
                    "--chunk-size", str(CLI_CHUNK), "--solver-args",
                    json.dumps({"maxiter": 100, "tol": 0.0})]
        _cuda.reset_launch_counts()
        _, t_cli = timed(lambda: runpy.run_module(
            "lasso_tpu_torch", run_name="__main__", alter_sys=True))
        launches.update(_cuda.launch_counts())
        sys.argv = argv
        parts = [np.load(os.path.join(tmp, f"Z.{p}.npy"))
                 for p in ("values", "cols", "row_ptr")]
    check(np.array_equal(native.unpack_codes_csr(*parts, K), dense),
          "encode --csr writes the dense codes bit for bit")
    csr_bytes = v.nbytes + c.nbytes + rp.nbytes
    print(f"[20b] {CLI_ROWS}x{D}->{K}, chunks of {CLI_CHUNK}: dense "
          f"{t_dense:.4f} s, CSR {t_csr:.4f} s (packing {sum(packing):.4f} s "
          f"in {len(packing)} chunks on the host), CLI --csr {t_cli:.4f} s; "
          f"{dense.nbytes} dense bytes, {csr_bytes} CSR bytes "
          f"({1 - int(rp[-1]) / dense.size:.4f} of the codes zero); K1/K2 "
          f"launches {json.dumps(n_csr)} each way; card {card_line()}")
    return launches


def median_seconds(fn, reps=5):
    return float(np.median([timed(fn)[1] for _ in range(reps)]))


def phase_export(x_np, W_np):
    """(c): an exported encoder at the headline against sparse_encode."""
    W = torch.from_numpy(W_np).to(DEV)
    launches = collections.Counter()

    def counted(fn):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        launches.update(counts)
        return out, {k: v for k, v in counts.items()
                     if k.startswith("fista_") and v}

    blob, t_export = host_timed(lambda: export_encoder(
        W, alpha=ALPHA, batch_size=None, **EXPORT_KW))
    call, t_load = host_timed(lambda: load_encoder(blob))
    xs = {rows: torch.from_numpy(x_np[:rows]).to(DEV)
          for rows in EXPORT_ROWS}
    for rows, x in xs.items():
        z, n_call = counted(lambda: call(x, W))
        want, n_want = counted(lambda: sparse_encode(x, W, ALPHA,
                                                     **EXPORT_KW))
        check(torch.equal(z, want), f"exported codes at {rows} rows equal "
              f"sparse_encode's bit for bit")
        check(n_call == n_want and min(n_call.values()) > 0,
              f"exported and sparse_encode launch the same K1/K2 at {rows} "
              f"rows: {n_call} {n_want}")
        print(f"[20c] {rows} rows: exported codes equal sparse_encode's, "
              f"launches {json.dumps(n_call)}")
    x = xs[EXPORT_ROWS[0]]
    t_call = median_seconds(lambda: call(x, W))
    t_direct = median_seconds(lambda: sparse_encode(x, W, ALPHA,
                                                    **EXPORT_KW))
    stop_kw = {**EXPORT_KW, "tol": 1e-2}
    stop_blob, t_export2 = host_timed(lambda: export_encoder(
        W, alpha=ALPHA, return_iters=True, **stop_kw))
    stop = load_encoder(stop_blob)
    (z, k), n_stop = counted(lambda: stop(x, W))
    (want, k_want), n_stop_want = counted(lambda: sparse_encode(
        x, W, ALPHA, return_iters=True, **stop_kw))
    check(torch.equal(z, want) and int(k) == k_want < EXPORT_KW["maxiter"]
          and n_stop == n_stop_want,
          f"the tol 1e-2 export stops early with sparse_encode's codes and "
          f"launches: {int(k)} and {k_want} iterations, {n_stop} "
          f"{n_stop_want}")
    print(f"[20c] export {t_export:.3f} s (the second {t_export2:.3f} s), "
          f"load {t_load:.3f} s, "
          f"{len(blob)} bytes; a call at {x.shape[0]} rows {t_call:.4f} s, "
          f"sparse_encode {t_direct:.4f} s (medians of 5); tol 1e-2 stops "
          f"at {int(k)} iterations exported, {k_want} in sparse_encode; "
          f"card {card_line()}")
    return launches


def phase_resumable(X_np):
    """(d): dict_learning_resumable on (a)'s patches."""
    X = torch.from_numpy(X_np).to(DEV)
    launches = collections.Counter()
    saves = []
    save = CKPT.save_checkpoint

    def timed_save(*a, **k):
        out, secs = timed(lambda: save(*a, **k))
        saves.append(secs)
        return out

    def run(fn):
        _cuda.reset_launch_counts()
        out, secs = timed(fn)
        counts = _cuda.launch_counts()
        launches.update(counts)
        return out, secs, counts.get("fista_resid_f32", 0)

    def gen():
        return torch.Generator(device=DEV).manual_seed(0)

    (W0, l0), t_plain, n_plain = run(lambda: DL.dict_learning(
        X, DL_K, generator=gen(), **DL_KW))
    with tempfile.TemporaryDirectory() as tmp:
        CKPT.save_checkpoint = timed_save
        try:
            (W1, l1), t_res, n_res = run(lambda: dict_learning_resumable(
                X, DL_K, generator=gen(), ckpt_dir=tmp,
                save_every=DL_SAVE_EVERY, **DL_KW))
            check(torch.equal(W1, W0) and torch.equal(l1, l0),
                  "resumable training equals dict_learning bit for bit")
            state_bytes = os.path.getsize(os.path.join(
                tmp, str(DL_KEEP), "state.pt"))
            for step in os.listdir(tmp):
                if int(step) > DL_KEEP:
                    shutil.rmtree(os.path.join(tmp, step))
            check(latest_step(tmp) == DL_KEEP, "checkpoints after step 6 "
                  "deleted")
            (W2, l2), t_resume, n_resume = run(
                lambda: dict_learning_resumable(
                    X, DL_K, generator=gen(), ckpt_dir=tmp,
                    save_every=DL_SAVE_EVERY, **DL_KW))
        finally:
            CKPT.save_checkpoint = save
    steps = DL_KW["steps"]
    check(torch.equal(W2, W0) and torch.equal(l2, l0),
          "the resumed run equals the uninterrupted one bit for bit")
    check(n_plain > 0 and n_res == n_plain
          and n_resume * steps == n_plain * (steps - DL_KEEP),
          f"K1 launches: dict_learning {n_plain}, resumable {n_res}, "
          f"resumed from step {DL_KEEP} {n_resume}")
    print(f"[20d] {DL_N}x{DL_PATCH * DL_PATCH}->{DL_K}, {steps} EM steps: "
          f"dict_learning {t_plain / steps:.4f} s a step, resumable "
          f"{t_res / steps:.4f} s a step with {len(saves)} saves of "
          f"{np.median(saves):.4f} s (median), {state_bytes} bytes each; "
          f"resumed from step {DL_KEEP}: {t_resume:.4f} s, K1 launches "
          f"{n_plain}/{n_res}/{n_resume}; losses {l0[0]:.6f} -> "
          f"{l0[-1]:.6f}; card {card_line()}")
    return launches


def phase_configs_profiling(x_np, W_np):
    """(e): a typed config against sparse_encode, a trace of one encode,
    time_solver and debug_nans."""
    x = torch.from_numpy(x_np).to(DEV)
    W = torch.from_numpy(W_np).to(DEV)
    kw = dict(maxiter=200, tol=0.0, kernel_precision="mixed")
    launches = collections.Counter()

    def counted(fn):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = _cuda.launch_counts()
        launches.update(counts)
        return out, counts

    z, n_cfg = counted(lambda: config_for("ista", **kw).encode(x, W, ALPHA))
    want, n_se = counted(lambda: sparse_encode(x, W, ALPHA, **kw))
    check(torch.equal(z, want) and n_cfg == n_se,
          "config_for('ista').encode equals sparse_encode with the same "
          "launches")
    with tempfile.TemporaryDirectory() as tmp:
        with capture_trace(tmp):
            with trace("encode"):
                counted(lambda: sparse_encode(x, W, ALPHA, **kw))
        files = os.listdir(tmp)
        check(len(files) == 1, f"one trace file: {files}")
        text = open(os.path.join(tmp, files[0])).read()
    events = json.loads(text)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted(n for n in names if "fista_resid" in n
                     or "fista_grad_prox" in n)
    check("encode" in names and any("fista_resid" in n for n in kernels)
          and any("fista_grad_prox" in n for n in kernels),
          "the trace holds the region and the K1/K2 kernels")
    lr = float(1.0 / lipschitz_constant(W))
    secs, _ = time_solver(sparse_encode, x, W, ALPHA, lr=lr, maxiter=200,
                          tol=0.0, kernel_precision="mixed",
                          mixed_tail_iters=37)
    _cuda.reset_launch_counts()
    try:
        with debug_nans():
            torch.log(torch.full((), -1.0, device=DEV))
        raised = False
    except FloatingPointError:
        raised = True
    check(raised, "debug_nans raises FloatingPointError on log(-1)")
    with debug_nans():
        z, _ = counted(lambda: sparse_encode(x, W, ALPHA, **kw))
    check(torch.equal(z, want), "a headline encode under debug_nans")
    print(f"[20e] config encode equals sparse_encode; trace: "
          f"{len(events)} events, the region and {len(kernels)} K1/K2 "
          f"kernel names; time_solver of phase 2's encode "
          f"{secs:.4f} s (phase 2 {RESULTS['headline_s']:.4f} s); "
          f"debug_nans raised on log(-1) and not in an encode; card "
          f"{card_line()}")
    return launches


def phase_last_modules(x_np, W_np):
    """Phase 20; returns the K1/K2 launches of its main-path runs."""
    X = phase_native()
    launches = collections.Counter()
    launches.update(phase_csr_serving())
    launches.update(phase_export(x_np, W_np))
    launches.update(phase_resumable(X))
    launches.update(phase_configs_profiling(x_np, W_np))
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[0] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _cuda.build(["fista", "cd", "group", "omp", "chol", "conv"],
                       ptxas_verbose=True)
    print(f"[0] kernels built in {time.perf_counter() - t0:.2f} s")
    for line in "".join(logs.values()).splitlines():
        if "registers" in line or "spill" in line or "wgmma" in line:
            print(f"[0] ptxas: {line.strip()}")
    # K6a, K1 and K2 run on the tensor cores (warpgroup MMA, HGMMA in
    # SASS) in both precisions; no other omp or fista kernel does. K9a and
    # K9b do in both precisions and in every n width they are built for:
    # no conv kernel without HGMMA is left
    omp_mma, fista_mma = sass_mma_counts("omp"), sass_mma_counts("fista")
    conv_mma = sass_mma_counts("conv")
    mma = {f"{name}_{kp}": sum(v for k, v in counts.items()
                               if f"{name}_kernelILb{int(kp == 'f32')}" in k)
           for counts, names in ((omp_mma, ("omp_select",)),
                                 (fista_mma, ("fista_resid",
                                              "fista_grad_prox")),
                                 (conv_mma, ("conv_decode_resid",
                                             "conv_adjoint_prox")))
           for name in names for kp in ("f32", "bf16")}
    total = (sum(omp_mma.values()) + sum(fista_mma.values())
             + sum(conv_mma.values()))
    print(f"[0] HGMMA in the SASS: {json.dumps(mma)}, in the other omp and "
          f"fista kernels {total - sum(mma.values())}; conv kernels without "
          f"HGMMA {sorted(k for k, v in conv_mma.items() if v == 0)}")
    check(min(mma.values()) > 0 and total == sum(mma.values())
          and min(conv_mma.values()) > 0,
          "HGMMA in K6a, in all four K1/K2 kernels and in every K9a/K9b "
          "kernel, in no other kernel")

    phase_kernel_cases()
    rows = phase_kernel_timing()
    x_np, W_np = headline_problem()
    counts = phase_headline(x_np, W_np)
    for row in rows:
        row["launches"] = counts[row["name"]]
    rows.append(phase_single_step(x_np, W_np))
    phase_cli()
    cd_rows = phase_cd_kernels()
    X_train = training_data()
    counts = phase_train_cli(X_train)
    # phase 6 runs K3 at the training width; the headline row is the same
    # kernel at phase 5's headline shape
    for key in ("cd_steps_f32", "cd_steps_f32_train"):
        rows.append({**cd_rows[key], "launches": counts["cd_steps_f32"]})
    sweeps = phase_cd_mod(X_train, x_np, W_np)
    rows.append({**cd_rows["cd_mod_sweep"], "launches": sweeps["headline"]})
    rows.append({**cd_rows["cd_mod_sweep_train"],
                 "launches": sweeps["train"]})
    group_rows = phase_group_kernels()
    counts = phase_group_slice(*group_problem())
    for kp in ("f32", "bf16"):
        rows.append({**group_rows[kp], "launches": counts[f"group_prox_{kp}"]})
    omp_rows = phase_omp_kernels()
    counts = phase_omp_slice(*omp_problem())
    for name, row in omp_rows.items():
        rows.append({**row, "launches": counts.get(name, 0)})
    chol_row = phase_chol_solve()
    counts = phase_chol_full(*omp_problem())
    chol_row = {**chol_row, "launches": counts["chol_solve"]}
    rows.append(chol_row)
    conv_rows, conv_rich_rows = phase_conv_kernels()
    counts = phase_conv_slice()
    for name, row in conv_rows.items():
        rows.append({**row, "launches": counts.get(name, 0)})
    t16 = time.perf_counter()
    counts, chol_train_row = phase_solvers(*headline_problem())
    # K8's launches on this slice's path: iter-ridge and interior-point on
    # their Cholesky routes at the training width
    rows.append({**chol_train_row, "launches": counts["chol_solve"]})
    print(f"[16] phase time {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    dl = phase_conv_dl()
    implicit = phase_implicit()
    # phase 17's launches go to the rows of the same kernel at the same
    # shape: K1, K2 and K5 at the headline, K9a/K9b at the conv headline
    # (conv DL and the conv encoder) and at the rich width (conv DL), the
    # rich rows phase 14's timings of that shape
    added = collections.Counter(implicit)
    added.update(dl["headline"])
    names = ("fista_resid_f32", "fista_grad_prox_f32", "group_prox_f32",
             *(f"{k}_{kp}" for k in ("conv_decode_resid", "conv_adjoint_prox")
               for kp in ("f32", "bf16")))
    launched = {name: added[name] for name in names}
    rich = {name: dl["rich"][name] for name in conv_rich_rows}
    print(f"[17] launches: {json.dumps(launched)}; at the rich width "
          f"{json.dumps(rich)}")
    for row in rows:
        if row["name"] in launched and "shape" not in row:
            row["launches"] += launched[row["name"]]
    rows.extend({**row, "launches": rich[name]}
                for name, row in conv_rich_rows.items())
    print(f"[17] phase time {time.perf_counter() - t17:.1f} s")
    t18 = time.perf_counter()
    counts, chol_nl_row = phase_nonlinear()
    # K8's launches on this slice's path: iterative_ridge_bfgs through the
    # MLP at K = 256
    rows.append({**chol_nl_row, "launches": counts.get("chol_solve", 0)})
    print(f"[18] phase time {time.perf_counter() - t18:.1f} s")
    t19 = time.perf_counter()
    counts = phase_parallel(*headline_problem(), X_train)
    # phase 19's launches go to the rows of the same kernel: K1/K2 at the
    # headline and the training width, K9a/K9b at the conv headline
    launched = {row["name"]: counts.get(row["name"], 0) for row in rows
                if "shape" not in row and counts.get(row["name"], 0)}
    print(f"[19] launches: {json.dumps(launched)}")
    for row in rows:
        if row["name"] in launched and "shape" not in row:
            row["launches"] += launched[row["name"]]
    print(f"[19] phase time {time.perf_counter() - t19:.1f} s")
    t20 = time.perf_counter()
    counts = phase_last_modules(*headline_problem())
    # phase 20's launches go to the K1/K2 rows at the headline
    launched = {row["name"]: counts.get(row["name"], 0) for row in rows
                if "shape" not in row and counts.get(row["name"], 0)}
    print(f"[20] launches: {json.dumps(launched)}")
    check(all(launched.get(f"{k}_{kp}", 0) > 0
              for k in ("fista_resid", "fista_grad_prox")
              for kp in ("f32", "bf16")), "phase 20 launched K1/K2")
    for row in rows:
        if row["name"] in launched and "shape" not in row:
            row["launches"] += launched[row["name"]]
    print(f"[20] phase time {time.perf_counter() - t20:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_encode_rank(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4]))
    sys.exit(main())
