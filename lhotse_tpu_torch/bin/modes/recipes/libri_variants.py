"""The ``prepare`` commands of the LibriSpeech-derived mixture corpora
LibriMix, MiniLibriMix, LibriSpeechMix and Spatial LibriSpeech (copied from
``lhotse_tpu/bin/modes/recipes/libri_variants.py``; the port has no
downloads)."""
import click

from lhotse_tpu_torch.bin.modes.cli_base import prepare
from lhotse_tpu_torch.utils import Pathlike

__all__ = ["librimix", "librimix_mini", "librispeechmix", "spatial_librispeech"]


@prepare.command(context_settings=dict(show_default=True))
@click.argument("librispeech_root_path", type=click.Path(exists=True))
@click.argument("wham_recset_root_path", type=click.Path(exists=True))
@click.argument("librimix_metadata_path", type=click.Path(exists=True))
@click.argument("workdir", type=click.Path())
@click.argument("output_dir", type=click.Path())
@click.option(
    "-n", "--n_src", "--n-src", "n_src", type=int, default=2,
    help="Number of mixed sources (2 or 3).")
@click.option("-j", "--num-jobs", type=int, default=1)
def librimix(
    librispeech_root_path: Pathlike, wham_recset_root_path: Pathlike,
    librimix_metadata_path: Pathlike, workdir: Pathlike, output_dir: Pathlike,
    n_src: int, num_jobs: int):
    """LibriMix virtual-mixture data preparation."""
    from lhotse_tpu_torch.recipes.librimix import prepare_librimix

    prepare_librimix(
        librispeech_root_path, wham_recset_root_path, librimix_metadata_path,
        workdir, output_dir=output_dir, n_src=n_src, num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("librimix_csv", type=click.Path(exists=True, dir_okay=False))
@click.argument("output_dir", type=click.Path())
@click.option("--with-precomputed-mixtures/--no-precomputed-mixtures", default=False)
@click.option("--sampling-rate", type=int, default=16000)
@click.option("--min-segment-seconds", type=float, default=3.0)
def librimix_mini(
    librimix_csv: Pathlike, output_dir: Pathlike, with_precomputed_mixtures: bool,
    sampling_rate: int, min_segment_seconds: float):
    """MiniLibriMix data preparation (single metadata CSV)."""
    from lhotse_tpu_torch.recipes.librimix_mini import prepare_librimix_mini

    prepare_librimix_mini(
        librimix_csv, output_dir=output_dir,
        with_precomputed_mixtures=with_precomputed_mixtures,
        sampling_rate=sampling_rate, min_segment_seconds=min_segment_seconds)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("librispeech_root_path", type=click.Path(exists=True))
@click.argument("librispeechmix_metadata_path", type=click.Path(exists=True))
@click.argument("output_dir", type=click.Path())
@click.option("-j", "--num-jobs", type=int, default=1)
def librispeechmix(
    librispeech_root_path: Pathlike, librispeechmix_metadata_path: Pathlike,
    output_dir: Pathlike, num_jobs: int):
    """LibriSpeechMix virtual-mixture data preparation."""
    from lhotse_tpu_torch.recipes.librispeechmix import prepare_librispeechmix

    prepare_librispeechmix(
        librispeech_root_path, librispeechmix_metadata_path, output_dir=output_dir,
        num_jobs=num_jobs)


@prepare.command(context_settings=dict(show_default=True))
@click.argument("corpus_dir", type=click.Path(exists=True, dir_okay=True))
@click.argument("output_dir", type=click.Path())
@click.option("-p", "--dataset-parts", type=str, multiple=True, default=["train", "test"])
@click.option("--normalize-text", type=click.Choice(["none", "lower"]), default="none")
@click.option("-j", "--num-jobs", type=int, default=1)
def spatial_librispeech(
    corpus_dir: Pathlike, output_dir: Pathlike, dataset_parts, normalize_text: str,
    num_jobs: int):
    """Spatial LibriSpeech data preparation."""
    from lhotse_tpu_torch.recipes.spatial_librispeech import prepare_spatial_librispeech

    prepare_spatial_librispeech(
        corpus_dir, output_dir=output_dir, dataset_parts=list(dataset_parts),
        normalize_text=normalize_text, num_jobs=num_jobs)
