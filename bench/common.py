"""What the drivers share: the program's FR config and the base table, both
made from the cell's configuration file, and the device synchronise."""
from __future__ import annotations

import torch

from bench.reference import fr as ref_fr
from repro_torch.core.gbdi_fr import FRConfig

#: blob fields a cache slot keeps, as the reference encode names them
SLOT_KEYS = ("ptrs", "deltas", "out_vals", "out_idx", "n_out")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_fr(cell) -> FRConfig:
    """The cell's FR configuration, as the program takes it."""
    f = cell.config["fr"]
    return FRConfig(word_bits=f["word_bits"], page_words=f["page_words"],
                    num_bases=f["num_bases"], width_set=tuple(f["width_set"]),
                    bucket_caps=tuple(f["bucket_caps"]), outlier_cap=f["outlier_cap"],
                    cap_profiles=(None if f.get("cap_profiles") is None
                                  else tuple(tuple(p) for p in f["cap_profiles"])))


def table_sample(cell, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The fit's sample: half from the first row's K words, half from its V."""
    half = cell.config["table_fit"]["sample_words"] // 2
    return torch.cat([ref_fr.bf16_to_words(k[0].reshape(-1)[:half]),
                      ref_fr.bf16_to_words(v[0].reshape(-1)[:half])])


def fit_table(cell, words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The cell's base table, fitted by the frozen reference on the host in
    one thread, so that a seed always gives the same table."""
    fit = cell.config["table_fit"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ref_fr.fit_table(words.cpu(), cell.fr, iters=fit["iters"],
                                sample_cap=fit["sample_words"])
    finally:
        torch.set_num_threads(threads)
