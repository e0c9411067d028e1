"""sigma_tpu — a sparse linear-algebra framework for accelerators, in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the SiGMA
Fortran library (graphs as first-class sparsity objects; matrices = graph +
values; operator algebra; Krylov solvers; Lanczos eigensolvers), built
accelerator-first: static-shape frozen topologies, whole-array kernels, jit-compiled
``lax.while_loop`` solver iterations, and mesh-sharded distribution.

This umbrella module re-exports the public API, mirroring
``/root/reference/src/sigma.f90``.
"""

from sigma_tpu.matrix import (
    BSRMatrix,
    DIAMatrix,
    PrunedDIAMatrix,
    SymmetricPrunedDIAMatrix,
    SymmetricDIAMatrix,
    BlockMatrix,
    PtAPPlan,
    SparseSumPlan,
    SpGEMMPlan,
    plan_ptap,
    plan_rart,
    plan_sparse_add,
    plan_sparse_matmul,
    ptap,
    rart,
    sparse_add,
    sparse_matmul,
    COOMatrix,
    CSCMatrix,
    CSRMatrix,
    ELLMatrix,
    SparseMatrix,
    choose_matrix_type,
    convert_matrix,
    num_matrix_types,
)
from sigma_tpu.operators import (
    AdjointOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    MatvecOperator,
    OperatorWithSolver,
    ProductOperator,
    ScaledOperator,
    SumOperator,
    aslinearoperator,
    attach_solver,
)
from sigma_tpu.eigen import (
    LOBPCGResult,
    LanczosResult,
    lobpcg,
    eigensolve,
    generalized_eigensolve,
    generalized_lanczos,
    lanczos,
)
from sigma_tpu.vectors import BlockVector
from sigma_tpu.utils.util import determinant, init_seed, order
from sigma_tpu.utils.checks import (
    checked,
    checked_solve,
    debug_nans,
    validate_matrix,
)
from sigma_tpu import fem, io
from sigma_tpu.parallel import (
    DistributedMatrix,
    distribute_matrix,
    distribute_vector,
    make_mesh,
    undistribute_vector,
)
from sigma_tpu.graph import (
    BSRGraph,
    DIAGraph,
    COOGraph,
    CSCGraph,
    CSRGraph,
    ELLGraph,
    Graph,
    GraphBuilder,
    breadth_first_search,
    build_graph,
    choose_graph_type,
    convert_graph,
    greedy_color_ordering,
    greedy_coloring,
    num_graph_types,
)

__version__ = "0.1.0"
