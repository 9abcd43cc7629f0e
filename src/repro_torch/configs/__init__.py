from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      ShapeSpec, SHAPES, Tunables,
                                      DEFAULT_TUNABLES, supports, reduced)
from repro_torch.configs.registry import (ARCHS, get_config, get_shape,
                                          all_cells)
