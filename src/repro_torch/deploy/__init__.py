"""Deployment backends of the port: the ``DeployedArtifact`` protocol,
the string-keyed registry, the packed and unpacked digital backends and
the padding helpers."""
from repro_torch.deploy.base import DeployedArtifact  # noqa: F401
from repro_torch.deploy.digital import (  # noqa: F401
    DeployedMemhd, deploy_packed, deploy_unpacked,
)
from repro_torch.deploy.padding import (  # noqa: F401
    pad_rows, pad_tiles, pad_to_multiple, pad_vec, round_up,
)
from repro_torch.deploy.registry import (  # noqa: F401
    available_backends, deploy, get_backend, register_backend,
)
