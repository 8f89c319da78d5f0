from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    ALL_SHAPES,
    SHAPES_BY_NAME,
    shapes_for,
)
from repro_torch.configs.registry import (
    ARCH_IDS,
    all_cells,
    all_configs,
    get_config,
    get_matrix_config,
    get_shape,
    get_smoke_config,
    resolve_config,
    skipped_cells,
)
