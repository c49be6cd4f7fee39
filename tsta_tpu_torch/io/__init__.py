from tsta_tpu_torch.io.seqio import (
    SeqRecord,
    open_seq,
    read_fasta,
    read_fastq,
    read_first_record,
    read_records,
    write_fasta,
    write_fastq,
)
from tsta_tpu_torch.io.encode import encode_dna, pad_to_multiple

__all__ = [
    "SeqRecord",
    "open_seq",
    "read_fasta",
    "read_fastq",
    "read_first_record",
    "read_records",
    "write_fasta",
    "write_fastq",
    "encode_dna",
    "pad_to_multiple",
]
