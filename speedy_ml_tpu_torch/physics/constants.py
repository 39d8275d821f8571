"""Physics parametrization constants.

Values mirror the reference's mod_cnvcon/mod_lsccon/mod_radcon/mod_sflcon/
mod_vdicon modules so that hybrid weights trained against the reference
model remain valid.
"""

# --- convection (mod_cnvcon.f90) ---
PSMIN = 0.8      # min norm. sfc pressure for convection
TRCNV = 6.0      # relaxation time [h]
RHBL = 0.9       # RH threshold in PBL
RHIL = 0.7       # RH threshold in intermediate layers (secondary flux)
ENTMAX = 0.5     # max entrainment (fraction of cloud-base mass flux)
SMF = 0.8        # secondary/primary mass flux ratio

# --- large-scale condensation (mod_lsccon.f90) ---
TRLSC = 4.0      # relaxation time [h]
RHLSC = 0.9      # max RH threshold (sigma=1)
DRHLSC = 0.1     # vertical range of RH threshold
RHBLSC = 0.95    # RH threshold in PBL

# --- radiation and clouds (mod_radcon.f90) ---
SOLC = 342.0
ALBSEA = 0.07
ALBICE = 0.60
ALBSN = 0.60
RHCL1 = 0.30
RHCL2 = 1.00
QACL = 0.20
WPCL = 0.2
PMAXCL = 10.0
CLSMAX = 0.60
CLSMINL = 0.15
GSE_S0 = 0.25
GSE_S1 = 0.40
ALBCL = 0.43
ALBCLS = 0.50
EPSSW = 0.020
EPSLW = 0.05
EMISFC = 0.98
ABSDRY = 0.033
ABSAER = 0.033
ABSWV1 = 0.022
ABSWV2 = 15.0
ABSCL1 = 0.015
ABSCL2 = 0.15
ABLWIN = 0.3
ABLCO2 = 6.0
ABLWV1 = 0.7
ABLWV2 = 50.0
ABLCL1 = 12.0
ABLCL2 = 0.6

# --- surface fluxes (mod_sflcon.f90) ---
FWIND0 = 0.95
FTEMP0 = 1.0
FHUM0 = 0.0
CDL = 2.4e-3
CDS = 1.0e-3
CHL = 1.2e-3
CHS = 0.9e-3
VGUST = 5.0
CTDAY = 1.0e-2
DTHETA = 3.0
FSTAB = 0.67
HDRAG = 2000.0
FHDRAG = 0.5
CLAMBDA = 7.0
CLAMBSN = 7.0

# --- vertical diffusion (mod_vdicon.f90) ---
TRSHC = 6.0
TRVDI = 24.0
TRVDS = 6.0
REDSHC = 0.5
RHGRAD = 0.5
SEGRAD = 0.1

# --- surface/soil (mod_surfcon.f90) ---
SWCAP = 0.30
SWWIL = 0.17
SD2SC = 60.0

SSTFR = 273.2 - 1.8   # freezing point of sea water
