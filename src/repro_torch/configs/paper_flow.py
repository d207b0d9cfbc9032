"""The paper's own workloads (§4 grid cuts, §5 assignment) as configs."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FlowBenchConfig:
    name: str
    kind: str                 # "grid_maxflow" | "assignment"
    grid: tuple = (512, 512)  # grid graph size (vision-scale, [4]'s datasets)
    n: int = 30               # assignment size (paper §6: |X|=|Y|<=30)
    max_cost: int = 100       # paper §6: costs <= 100


GRID_BENCH = FlowBenchConfig(name="paper-grid-maxflow", kind="grid_maxflow")
ASSIGN_BENCH = FlowBenchConfig(name="paper-assignment", kind="assignment")
