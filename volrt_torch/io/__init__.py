from volrt_torch.io.pvm import (  # noqa: F401
    load_volume,
    read_dds,
    read_pvm,
    read_raw,
    write_pvm,
)
