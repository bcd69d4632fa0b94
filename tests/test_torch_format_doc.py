"""The port's ``docs/FORMAT.md`` generator (``repro_torch.core.format_doc``)
against the document and the JAX package's ``repro.core.format_doc``: the
worked-example block is byte-identical to a live port encode and to the
reference's, the example page roundtrips outside its drop, and the blob
equals the reference's field by field."""
import re
import runpy
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import format_doc
from repro_torch.core.gbdi_fr import fr_decode, fr_encode

DOC = Path(__file__).resolve().parent.parent / "docs" / "FORMAT.md"
_BLOCK = re.compile(
    r"<!-- BEGIN WORKED EXAMPLE[^>]*-->\n```text\n(.*?)\n```\n"
    r"<!-- END WORKED EXAMPLE -->", re.S)


def test_doc_worked_example_matches_live_encode():
    m = _BLOCK.search(DOC.read_text())
    assert m, "FORMAT.md worked-example markers missing"
    assert m.group(1) == format_doc.worked_example(), (
        "docs/FORMAT.md worked example is stale — regenerate with "
        "`python -m repro_torch.core.format_doc` and paste between the markers")


def test_example_page_roundtrips_outside_drops():
    cfg = format_doc.example_config()
    x = torch.from_numpy(format_doc.example_page()[None, :].astype(np.int32))
    blob = fr_encode(x, format_doc.example_table(), cfg)
    assert int(blob["n_spilled"][0]) == 4
    assert int(blob["n_dropped"][0]) == 1
    got = fr_decode(blob, format_doc.example_table(), cfg)[0].numpy()
    mism = np.nonzero(got != x[0].numpy())[0]
    assert mism.size == 1 and got[mism[0]] == 0    # exactly the dropped word


def test_serialized_page_sizes_follow_selected_profile():
    cfg, blob = format_doc.encode_example()
    page = format_doc.serialize_page(blob, cfg)
    # worked page keeps profile 0 (exactness-first probe): 81 bytes incl.
    # the 1-byte profile header; the static buffer bound is the max profile
    assert int(np.asarray(blob["profile"])) == 0
    assert len(page) == cfg.compressed_bytes_for_profile(0) == 81
    assert cfg.compressed_bytes_per_page() == 81
    assert page[0] == 0                            # profile id header byte
    # zero page serializes deterministically and picks the *smaller*
    # narrow-heavy profile 1 (nothing drops, size wins): 77 bytes
    zero_blob = {k: v[0] for k, v in fr_encode(
        torch.zeros((1, cfg.page_words), dtype=torch.int32), format_doc.example_table(),
        cfg).items()}
    assert int(zero_blob["profile"]) == 1
    a = format_doc.serialize_page(zero_blob, cfg)
    b = format_doc.serialize_page(zero_blob, cfg)
    assert a == b and len(a) == cfg.compressed_bytes_for_profile(1) == 77
    assert a[0] == 1


def test_worked_example_is_the_reference_one_and_the_cli_prints_it(capsys):
    from repro.core import format_doc as ref

    assert format_doc.worked_example() == ref.worked_example()
    runpy.run_path(format_doc.__file__, run_name="__main__")
    assert capsys.readouterr().out == _BLOCK.search(DOC.read_text()).group(1) + "\n"


def test_encode_example_blob_equals_the_reference_field_by_field():
    from repro.core import format_doc as ref

    cfg, blob = format_doc.encode_example()
    rcfg, rblob = ref.encode_example()
    assert sorted(blob) == sorted(rblob)
    for k in rblob:
        assert np.array_equal(blob[k], np.asarray(rblob[k])), k
    assert format_doc.serialize_page(blob, cfg) == ref.serialize_page(rblob, rcfg)
    assert np.array_equal(format_doc.example_page(), ref.example_page())
    assert format_doc.example_table().bases.dtype == torch.int32
