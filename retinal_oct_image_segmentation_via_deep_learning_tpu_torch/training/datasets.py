"""Public retinal-OCT dataset registry (the JAX package's
``training/datasets.py``, copied: data only).

The reference's ``Datasets.md`` table (21 public datasets with volumes,
pathologies and links, ``Datasets.md:3-26``) as data, so tooling can
enumerate and filter it. The loaders (``duke.py``, ``retouch.py``,
``png_volumes.py``, dispatched by ``data.load_real_dataset``) read the
distribution formats of DUKE-DME, RETOUCH and AROI-style PNG folders.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetInfo:
    name: str
    volume: str  # provider-reported size
    diseases: str  # pathology mix (H.=healthy, see ABBREVIATIONS)
    url: str = ""
    task: str = "layers"  # layers | lesions | classification


ABBREVIATIONS = {
    "H.": "healthy",
    "G.": "glaucoma",
    "POAG": "primary open-angle glaucoma",
    "AMD": "age-related macular degeneration",
    "nAMD": "neovascular AMD",
    "CNV": "choroidal neovascularization",
    "DR": "diabetic retinopathy",
    "DME": "diabetic macular edema",
    "MH": "macular hole",
    "MS": "multiple sclerosis",
    "IRF": "intraretinal fluid",
    "SRF": "subretinal fluid",
    "PED": "pigment epithelial detachment",
}

DATASETS: dict[str, DatasetInfo] = {
    d.name: d
    for d in [
        DatasetInfo("DUKE-AMD", "20 volumes", "20 AMD",
                    "http://www.duke.edu/sf59/Chiu_IOVS_2011_dataset.htm"),
        DatasetInfo("DUKE-WLOA", "38800 B-scans", "269 AMD; 115 H.",
                    "http://people.duke.edu/wsf59/RPEDC_Ophth_2013_dataset.htm"),
        DatasetInfo("DUKE-DME", "45 volumes", "15 dry AMD, 15 DME, 15 H.",
                    "http://www.duke.edu/~sf59/Srinivasan_BOE_2014_dataset.htm"),
        DatasetInfo("DUKE-Cyst", "6 volumes", "6 DME",
                    "http://www.duke.edu/~sf59/Chiu_BOE_2014_dataset.htm",
                    task="lesions"),
        DatasetInfo("SPIE", "19 volumes", "19 H.",
                    "https://www.kaggle.com/datasets/kmader/eye-oct-datasets"),
        DatasetInfo("MIAMI", "50 B-scans", "10 mild DR",
                    "https://www.ebi.ac.uk/biostudies/europepmc/studies/S-EPMC5025289"),
        DatasetInfo("OPTIMA", "30 B-scans", "IRF",
                    "https://optima.meduniwien.ac.at/optima-segmentation-challenge-1/",
                    task="lesions"),
        DatasetInfo("ROCC", "-", "DR, H."),
        DatasetInfo("HC-MS", "49 B-scans", "14 H., 21 MS",
                    "http://iacl.jhu.edu/Resources"),
        DatasetInfo("Cell", "108312 B-scans", "H., CNV, DME, Drusen",
                    "https://data.mendeley.com/datasets/rscbjbr9sj/3",
                    task="classification"),
        DatasetInfo("BIOMISA", "2497 B-scans, 19 C-scans, 64 fundus",
                    "14 AMD, 13 ME, 50 H., 26 glaucoma",
                    "http://biomisa.org/index.php/glaucoma-fundus-oct-dataset/"),
        DatasetInfo("Zenodo-Glaucoma", "1100 B-scans", "847 G., 263 H.",
                    "https://zenodo.org/records/14926793"),
        DatasetInfo("AI-challenger", "100 volumes", "REA, SRF, PED",
                    "https://github.com/AIChallenger/AI_Challenger_2018",
                    task="lesions"),
        DatasetInfo("RETOUCH", "112 volumes", "IRF, SRF, PED",
                    "https://retouch.grandchallenge.org", task="lesions"),
        DatasetInfo("Isfahan-MISP", "-", "-"),
        DatasetInfo("OCTID", "470 B-scans", "206 H., 102 MH, 55 AMD, 107 DR",
                    "https://dataverse.scholarsportal.info/dataverse/OCTID"),
        DatasetInfo("RAJA-Glaucoma", "50 volumes + fundus",
                    "18 H., 32 glaucoma"),
        DatasetInfo("AROI", "1136 B-scans", "24 nAMD",
                    "https://ipg.fer.hr/ipg/resources/oct_image_database"),
        DatasetInfo("OCTA-500", "500 volumes", "H., AMD, DR, CNV, CSC, RVO",
                    "https://ieee-dataport.org/open-access/octa-500"),
        DatasetInfo("Retinal-OCT-C8", "24000 B-scans",
                    "AMD, CNV, CSR, DME, DR, Drusen, MH, H.",
                    task="classification"),
        DatasetInfo("GOALS", "300 B-scans", "53 H., 13 glaucoma",
                    "https://aistudio.baidu.com/aistudio/competition/detail/230"),
        DatasetInfo("ORC-SS-OCT", "4 volumes", "4 RRD",
                    "https://data.mendeley.com/datasets/bzsc7gd9p3/2"),
    ]
}


def list_datasets(task: str | None = None) -> list[DatasetInfo]:
    return [d for d in DATASETS.values() if task is None or d.task == task]
