from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, ShapeCell, cell_applicable, get_config, get_smoke_config, sub_quadratic

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeCell", "cell_applicable", "get_config", "get_smoke_config", "sub_quadratic"]
