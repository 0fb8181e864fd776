"""Core of the PyTorch port: the Top-K eigensolver engines (Lanczos +
Jacobi), precision policies and operators.

User-facing entry point: ``repro_torch.eigsh``.  The ``topk_eigs*`` names
here are deprecated shims kept for compatibility.
"""

from .eigensolver import EigResult, FixedSolveOutput, solve_fixed, topk_eigs
from .jacobi import jacobi_eigh, jacobi_eigh_host, tridiag_to_dense
from .lanczos import LanczosResult, lanczos_tridiag
from .operators import (
    CallableOperator,
    ChunkedOperator,
    DenseOperator,
    HvpOperator,
    LinearOperator,
    SparseOperator,
    make_operator,
)
from .partition import PartitionedMatrix, nnz_balanced_splits, partition_matrix
from .precision import (
    BCF,
    BFF,
    DDD,
    FCF,
    FDF,
    FFF,
    HFF,
    PHASES,
    POLICIES,
    PrecisionPolicy,
    auto_ladder,
    phase_op_counts,
)
from .restarted import RestartedSolveOutput, solve_restarted, topk_eigs_restarted
