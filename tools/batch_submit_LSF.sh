#!/bin/bash
# Self-resubmitting LSF driver for a chained icar_tpu run.
# Counterpart of /root/reference/helpers/batch_submit_LSF.sh;
# see batch_submit_SLURM.sh for the chaining logic. Submit with:
#   bsub < tools/batch_submit_LSF.sh
#
#BSUB -J icar_tpu
#BSUB -W 01:00
#BSUB -o job_output/log-%J.out
#BSUB -e job_output/log-%J.err

set -u
PREFIX=${PREFIX:-run}
OPTFILE=${OPTFILE:-options.nml}
BATCHFILE=${BATCHFILE:-tools/batch_submit_LSF.sh}
REPO=${REPO:-$(cd "$(dirname "$0")/.." && pwd)}
SETUP_RUN="python $REPO/tools/setup_next_run.py"

mkdir -p job_output

if [[ ! -e ${PREFIX}_finished ]]; then
    bsub -w "ended(${LSB_JOBID})" < ${BATCHFILE}

    if [[ -e ${PREFIX}_running ]]; then
        $SETUP_RUN $OPTFILE > job_output/py_setup.out
    fi
    touch ${PREFIX}_running

    if python -m icar_tpu $OPTFILE; then
        touch ${PREFIX}_finished
    fi
fi
