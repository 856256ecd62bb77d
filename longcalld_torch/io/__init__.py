from longcalld_torch.io.fasta import FastaFile  # noqa: F401
from longcalld_torch.io.bam import BamReader, BamRecord  # noqa: F401
