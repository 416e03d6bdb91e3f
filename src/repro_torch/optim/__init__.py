from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig, adamw_init, adamw_update,
)
from repro_torch.optim.schedule import (  # noqa: F401
    ScheduleConfig, make_schedule,
)
from repro_torch.optim.compression import (  # noqa: F401
    ef_int8_compress, ef_int8_decompress,
)
