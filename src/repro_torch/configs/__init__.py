from repro_torch.configs.common import (
    ASSIGNED,
    ArchSpec,
    get_config,
    list_archs,
    register,
)

__all__ = ["ASSIGNED", "ArchSpec", "get_config", "list_archs", "register"]
