from titan_tpu_torch.config.options import (ConfigElement, ConfigNamespace, ConfigOption,
                                      Mutability, SEPARATOR)
from titan_tpu_torch.config.configuration import (Configuration, MapConfiguration,
                                            MergedConfiguration,
                                            ModifiableConfiguration,
                                            ReadConfiguration, Restriction,
                                            WriteConfiguration)
from titan_tpu_torch.config import defaults

__all__ = [
    "ConfigElement", "ConfigNamespace", "ConfigOption", "Mutability", "SEPARATOR",
    "Configuration", "MapConfiguration", "MergedConfiguration",
    "ModifiableConfiguration", "ReadConfiguration", "Restriction",
    "WriteConfiguration", "defaults",
]
