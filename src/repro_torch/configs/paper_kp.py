"""The paper's production workloads (Section 6): billion-scale sparse GKP
instances. ``table1`` is the Table 1 row (1e8 users, K = 10, Q = 1)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class KPWorkload:
    name: str
    n_users: int
    k: int                 # knapsacks (and items, sparse form)
    q: int                 # local cardinality cap
    tightness: float = 0.5


WORKLOADS = {
    "table1": KPWorkload("table1", 100_000_000, 10, 1),
    "billion": KPWorkload("billion", 1_000_000_000, 10, 1),
    "dense-fig1": KPWorkload("dense-fig1", 10_000, 10, 1),
}
